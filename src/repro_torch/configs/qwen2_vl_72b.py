"""qwen2-vl-72b [vlm]: M-RoPE, dynamic resolution; vision frontend STUBBED
(input_specs provides patch embeddings + 3-stream M-RoPE positions).
[arXiv:2409.12191; hf]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=29568,
    vocab=152064, act="silu",
    mrope_sections=(16, 24, 24),  # t/h/w split of head_dim/2 = 64
    source="arXiv:2409.12191",
)

SMOKE = ModelConfig(
    arch_id="qwen2-vl-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
    act="silu", mrope_sections=(4, 2, 2), compute_dtype="float32",
)

SHAPE_SKIPS = ("long_500k",)
