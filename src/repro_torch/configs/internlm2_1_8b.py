"""internlm2-1.8b [dense], GQA. [arXiv:2403.17297; hf]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="internlm2-1.8b", family="dense",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, d_ff=8192,
    vocab=92544, act="silu",
    source="arXiv:2403.17297",
)

SMOKE = ModelConfig(
    arch_id="internlm2-1.8b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
    act="silu", compute_dtype="float32",
)

SHAPE_SKIPS = ("long_500k",)
