"""smollm-135m [dense]: llama-arch small. [hf:HuggingFaceTB/SmolLM-135M; hf]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="smollm-135m", family="dense",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3, d_ff=1536,
    vocab=49152, act="silu",
    source="hf:HuggingFaceTB/SmolLM-135M",
)

SMOKE = ModelConfig(
    arch_id="smollm-135m-smoke", family="dense",
    n_layers=2, d_model=48, n_heads=3, n_kv_heads=1, d_ff=96, vocab=128,
    act="silu", compute_dtype="float32",
)

# pure full attention: 500k decode cache/quadratic prefill out of scope
SHAPE_SKIPS = ("long_500k",)
