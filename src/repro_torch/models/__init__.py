"""Model zoo registry: config -> model instance.

The port builds the dense all-global decoder family
(:class:`~repro_torch.models.transformer.TransformerLM`); the other
families of the reference's zoo (MoE, VLM, SSM, hybrid, encoder-decoder,
and the gemma3 local:global pattern) are ROADMAP slice 6b and raise
``NotImplementedError``.
"""
from repro_torch.models.common import ModelConfig, ShapeConfig, SHAPES


def build_model(cfg: ModelConfig):
    if cfg.family in ("dense", "moe", "vlm", "ssm", "hybrid", "encdec"):
        from repro_torch.models.transformer import TransformerLM
        return TransformerLM(cfg)  # raises for every family but dense
    raise ValueError(f"unknown family {cfg.family!r}")


__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "build_model"]
