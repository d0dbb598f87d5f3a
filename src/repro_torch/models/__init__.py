"""Model zoo registry: config -> model instance.

The port builds the decoder families of
:class:`~repro_torch.models.transformer.TransformerLM`: dense (with the
gemma3 local:global pattern), MoE and the VLM backbone. The SSM, hybrid
and encoder-decoder families are ROADMAP slice 6c and raise
``NotImplementedError``.
"""
from repro_torch.models.common import ModelConfig, ShapeConfig, SHAPES


def build_model(cfg: ModelConfig):
    if cfg.family in ("dense", "moe", "vlm", "ssm", "hybrid", "encdec"):
        from repro_torch.models.transformer import TransformerLM
        return TransformerLM(cfg)  # raises for ssm, hybrid and encdec
    raise ValueError(f"unknown family {cfg.family!r}")


__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "build_model"]
