"""Model zoo registry: config -> model instance.

The port builds every family of the reference: the decoder families of
:class:`~repro_torch.models.transformer.TransformerLM` (dense, with the
gemma3 local:global pattern, MoE and the VLM backbone), the Mamba2 SSM
(:class:`~repro_torch.models.ssm.MambaLM`), the Zamba2 hybrid
(:class:`~repro_torch.models.hybrid.HybridLM`) and the Whisper
encoder-decoder (:class:`~repro_torch.models.encdec.EncDecLM`).
"""
from repro_torch.models.common import ModelConfig, ShapeConfig, SHAPES


def build_model(cfg: ModelConfig):
    if cfg.family in ("dense", "moe", "vlm"):
        from repro_torch.models.transformer import TransformerLM
        return TransformerLM(cfg)
    if cfg.family == "ssm":
        from repro_torch.models.ssm import MambaLM
        return MambaLM(cfg)
    if cfg.family == "hybrid":
        from repro_torch.models.hybrid import HybridLM
        return HybridLM(cfg)
    if cfg.family == "encdec":
        from repro_torch.models.encdec import EncDecLM
        return EncDecLM(cfg)
    raise ValueError(f"unknown family {cfg.family!r}")


__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "build_model"]
