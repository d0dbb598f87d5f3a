"""whisper-medium [audio]: enc-dec, conv frontend STUBBED (input_specs
provides precomputed frame embeddings). [arXiv:2212.04356; unverified]

24 encoder + 24 decoder layers. Assigned shapes exercise the decoder at
stress lengths (4k/32k vs Whisper's 448) — backbone-only per the assignment.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-medium", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab=51865, act="gelu",
    n_enc_layers=24, n_frames=1500,
    source="arXiv:2212.04356",
)

SMOKE = ModelConfig(
    arch_id="whisper-medium-smoke", family="encdec",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=128,
    act="gelu", n_enc_layers=2, n_frames=12, compute_dtype="float32",
)

SHAPE_SKIPS = ("long_500k",)
