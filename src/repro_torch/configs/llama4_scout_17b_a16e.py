"""llama4-scout-17b-a16e [moe]: 16 experts top-1, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
    vocab=202048, act="silu",
    n_experts=16, moe_topk=1, capacity_factor=1.25,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)

SMOKE = ModelConfig(
    arch_id="llama4-scout-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=96, vocab=128,
    act="silu", n_experts=4, moe_topk=1, capacity_factor=8.0,  # drop-free for smoke determinism
    compute_dtype="float32",
)

SHAPE_SKIPS = ("long_500k",)
