"""Deterministic synthetic data: the port of ``src/repro/data/synthetic.py``.

``make_batch`` draws the reference's numpy arrays (the same generator, seed
and calls) and returns them as tensors on a device, deterministic in
(arch, shape, step) so restarts resume without data-loader state. The seed
is ``hash((arch_id, shape name, step))``, and Python salts the hash of a
string per process (``PYTHONHASHSEED``): two processes agree on a batch
only when that salt is fixed, so a batch is compared between the two
packages inside one process. ``input_specs`` and ``decode_inputs`` give the
dry-run's stand-ins: tensors on the ``meta`` device, which carry a shape
and a dtype and allocate nothing (the reference's ``ShapeDtypeStruct`` and
``jax.eval_shape``).

Modality frontends are stubs, as in the reference: [audio] gets frame
embeddings (B, n_frames, d); [vlm] gets patch/token embeddings (B, S, d)
plus 3-stream M-RoPE positions.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.sparse import resolve_device
from repro_torch.models.common import ModelConfig, ShapeConfig


def _rng(cfg: ModelConfig, shape: ShapeConfig, step: int) -> np.random.Generator:
    seed = abs(hash((cfg.arch_id, shape.name, step))) % (2 ** 31)
    return np.random.default_rng(seed)


def batch_for_shape(cfg: ModelConfig, shape: ShapeConfig,
                    batch_override: int | None = None,
                    seq_override: int | None = None):
    B = batch_override or shape.global_batch
    S = seq_override or shape.seq_len
    return B, S


def make_batch(cfg: ModelConfig, shape: ShapeConfig, step: int = 0,
               batch_override: int | None = None,
               seq_override: int | None = None,
               device=None) -> Dict[str, torch.Tensor]:
    """Training batch (kind='train') as tensors on ``device`` (``None`` =
    the CUDA card): int32 ``tokens`` and ``labels`` (B, S), and the stub
    frontends' inputs in the compute dtype."""
    dev = resolve_device(device)
    B, S = batch_for_shape(cfg, shape, batch_override, seq_override)
    rng = _rng(cfg, shape, step)
    toks = rng.integers(0, cfg.vocab, size=(B, S + 1), dtype=np.int32)
    batch: Dict[str, torch.Tensor] = {
        "tokens": torch.from_numpy(toks[:, :-1].copy()).to(dev),
        "labels": torch.from_numpy(toks[:, 1:].copy()).to(dev),
    }
    if cfg.family == "encdec":
        batch["embeds"] = torch.from_numpy(
            rng.standard_normal((B, cfg.n_frames, cfg.d_model)).astype(
                np.float32)).to(dev, cfg.cdtype)
    elif cfg.family == "vlm":
        batch["embeds"] = torch.from_numpy(
            rng.standard_normal((B, S, cfg.d_model)).astype(
                np.float32)).to(dev, cfg.cdtype)
        pos = np.broadcast_to(np.arange(S, dtype=np.int32), (3, B, S))
        batch["mrope_positions"] = torch.from_numpy(pos.copy()).to(dev)
        del batch["tokens"]
    return batch


def input_specs(cfg: ModelConfig, shape: ShapeConfig
                ) -> Dict[str, torch.Tensor]:
    """``meta`` tensors standing in for every model input of a
    train/prefill step (decode adds caches via :func:`decode_inputs`)."""
    B, S = shape.global_batch, shape.seq_len

    def sd(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    specs: Dict[str, torch.Tensor] = {
        "tokens": sd((B, S), torch.int32),
        "labels": sd((B, S), torch.int32),
    }
    if cfg.family == "encdec":
        specs["embeds"] = sd((B, cfg.n_frames, cfg.d_model), cfg.cdtype)
    elif cfg.family == "vlm":
        specs["embeds"] = sd((B, S, cfg.d_model), cfg.cdtype)
        specs["mrope_positions"] = sd((3, B, S), torch.int32)
        del specs["tokens"]
    if shape.kind != "train":
        del specs["labels"]
    return specs


def decode_inputs(cfg: ModelConfig, shape: ShapeConfig, model):
    """(cache specs, token spec) for a decode cell: the model's
    ``init_cache`` on the ``meta`` device (no allocation)."""
    B, S = shape.global_batch, shape.seq_len
    caches = model.init_cache(B, S, device="meta")
    return caches, torch.empty((B,), dtype=torch.int32, device="meta")
