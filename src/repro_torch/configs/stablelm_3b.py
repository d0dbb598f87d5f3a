"""stablelm-3b [dense]. [hf:stabilityai/stablelm-2-1_6b; unverified]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="stablelm-3b", family="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=6912,
    vocab=50304, act="silu",
    source="hf:stabilityai/stablelm-2-1_6b",
)

SMOKE = ModelConfig(
    arch_id="stablelm-3b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=128,
    act="silu", compute_dtype="float32",
)

SHAPE_SKIPS = ("long_500k",)
