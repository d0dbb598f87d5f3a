"""zamba2-2.7b [hybrid]: Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242; hf]

54 mamba2 layers (d_state 64); the SHARED attention+FFN block (one parameter
set) runs after every 6th mamba layer (9 invocation sites).
long_500k RUNS (hybrid: SSM state is O(1); 9 shared-attn KV sites at batch=1).
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=10240,
    vocab=32000, act="silu",
    ssm_state=64, ssm_head_dim=64, ssm_chunk=256, attn_every=6,
    source="arXiv:2411.15242",
)

SMOKE = ModelConfig(
    arch_id="zamba2-smoke", family="hybrid",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=128,
    act="silu", ssm_state=16, ssm_head_dim=16, ssm_chunk=8, attn_every=2,
    compute_dtype="float32",
)

SHAPE_SKIPS = ()
