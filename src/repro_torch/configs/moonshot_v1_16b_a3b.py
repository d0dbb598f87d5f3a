"""moonshot-v1-16b-a3b [moe]: kimi/moonlight, 64 experts top-6.
[hf:moonshotai/Moonlight-16B-A3B; hf]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab=163840, act="silu",
    n_experts=64, moe_topk=6, capacity_factor=1.25,
    source="hf:moonshotai/Moonlight-16B-A3B",
)

SMOKE = ModelConfig(
    arch_id="moonshot-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=96, vocab=128,
    act="silu", n_experts=8, moe_topk=2, capacity_factor=8.0,  # drop-free for smoke determinism
    compute_dtype="float32",
)

SHAPE_SKIPS = ("long_500k",)
