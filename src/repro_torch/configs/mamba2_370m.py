"""mamba2-370m [ssm]: SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]

long_500k RUNS (the O(1)-state showcase cell).
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab=50280,
    ssm_state=128, ssm_head_dim=64, ssm_chunk=256,
    source="arXiv:2405.21060",
)

SMOKE = ModelConfig(
    arch_id="mamba2-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=0, n_kv_heads=0, d_ff=0, vocab=128,
    ssm_state=16, ssm_head_dim=16, ssm_chunk=8, compute_dtype="float32",
)

SHAPE_SKIPS = ()
