"""gemma3-27b [dense]: 5:1 local:global sliding window, 128k context.
[hf:google/gemma-3-1b-pt; unverified]

62 layers = 10 groups of (5 local @ window 1024 + 1 global) + 2 extra local.
head_dim fixed at 128 (gemma3 convention: q_dim != d_model).
long_500k RUNS: 5/6 of layers are window-bounded; global layers hold the
500k KV at batch=1 (DESIGN.md §6)."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma3-27b", family="dense",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, d_ff=21504,
    vocab=262144, d_head=128, act="silu",
    sliding_window=1024, local_per_global=5,
    source="hf:google/gemma-3-27b-pt",
)

SMOKE = ModelConfig(
    arch_id="gemma3-27b-smoke", family="dense",
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
    d_head=16, act="silu", sliding_window=8, local_per_global=5,
    compute_dtype="float32",
)

SHAPE_SKIPS = ()
