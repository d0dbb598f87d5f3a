"""End to end: train a ~100M-param LM with checkpoint/restart fault
tolerance and optional top-k sparse-allreduce gradient compression (the
paper's technique), on the port.

The twin of ``examples/train_100m.py``, with ``--device`` (``cuda``, the
default, or ``cpu``)::

    PYTHONPATH=src python -m repro_torch.launch.train_100m --steps 200
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train_100m \\
        --steps 50 --compress --schedule gather_kway --k-fraction 0.05 --device cpu

Its world is the one ``torchrun`` gives it, or a world of one rank
(:func:`repro_torch.launch.world.process_world`); every rank is on the data
dim. The dense step keeps params and AdamW state as DTensors placed by
``params_shardings`` (FSDP over the data dim) and checkpoints them as
global arrays in one directory; ``--compress`` replicates them and each
rank checkpoints its own state. Resume after a crash: re-run the same
command; the Supervisor restores the latest complete checkpoint
automatically.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

from repro_torch import tree as _tree
from repro_torch.checkpoint import latest_step
from repro_torch.launch.train import global_batch, make_mesh
from repro_torch.launch.world import process_world
from repro_torch.models import build_model
from repro_torch.models.common import ModelConfig, ShapeConfig
from repro_torch.models.layers import use_full_precision
from repro_torch.optim import AdamWState, adamw_init
from repro_torch.runtime import Supervisor
from repro_torch.sharding.params import (batch_shardings, distribute,
                                         params_shardings)
from repro_torch.train import (TrainHParams, make_compressed_train_step,
                               make_train_step, rank_ef_state)

# ~100M params: 12L × d768 (GPT-2-small-ish with SwiGLU + GQA)
CFG = ModelConfig(arch_id="repro-100m", family="dense", n_layers=12,
                  d_model=768, n_heads=12, n_kv_heads=4, d_ff=2048,
                  vocab=32000, compute_dtype="float32")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_100m_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress", action="store_true",
                    help="top-k + SpKAdd sparse allreduce over the data dim")
    ap.add_argument("--schedule", default="gather_kway",
                    choices=["gather_kway", "tree_2way", "ring_2way"])
    ap.add_argument("--k-fraction", type=float, default=0.05)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    model = build_model(CFG)
    shape = ShapeConfig("train", "train", args.seq, args.batch)
    hp = TrainHParams(ce_chunk=max(32, args.seq // 8),
                      attn_chunk=max(64, args.seq // 4),
                      remat=True, total_steps=args.steps, warmup=20)
    use_full_precision()
    with process_world(args.device) as (rank, world, dev):
        lead = rank == 0
        params = model.init(0, device=dev)
        if lead:
            n_params = sum(x.numel() for x in _tree.leaves(params))
            print(f"model: {CFG.arch_id}, {n_params / 1e6:.1f}M params",
                  flush=True)
        mesh = make_mesh("auto", world, dev)
        state_sh = None
        if args.compress:
            opt = tuple(adamw_init(params))
            step_impl = make_compressed_train_step(
                model, mesh, hp, k_fraction=args.k_fraction,
                schedule=args.schedule)
            state0 = (params, opt, rank_ef_state(params))

            def step_fn(state, step):
                p, o, e = state
                batch = global_batch(CFG, shape, step, dev, world)
                p, o, e, metrics = step_impl(p, AdamWState(*o), e, batch)
                if lead and step % 10 == 0:
                    print(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                          f"gnorm {float(metrics['grad_norm']):.3f} "
                          f"[sparse-allreduce/{args.schedule}]", flush=True)
                return (p, tuple(o), e)
        else:
            p_sh = params_shardings(params, mesh)
            params = distribute(params, p_sh)
            opt = tuple(adamw_init(params))  # moments take the placements
            step_impl = make_train_step(model, hp)
            state0 = (params, opt)
            state_sh = (p_sh, (None, p_sh, p_sh))

            def step_fn(state, step):
                p, o = state
                batch = global_batch(CFG, shape, step, dev, world)
                batch = distribute(batch, batch_shardings(batch, mesh))
                p, o, metrics = step_impl(p, AdamWState(*o), batch)
                if lead and step % 10 == 0:
                    print(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                          f"gnorm {float(metrics['grad_norm']):.3f}",
                          flush=True)
                return (p, tuple(o))

        ckpt_dir = args.ckpt_dir
        if world > 1 and args.compress:
            ckpt_dir = os.path.join(ckpt_dir, f"rank{rank}")
        resumed = latest_step(ckpt_dir)
        if lead and resumed:
            print(f"resuming from checkpoint step {resumed}")
        sup = Supervisor(ckpt_dir, ckpt_every=args.ckpt_every,
                         async_ckpt=True)
        t0 = time.time()
        _, steps = sup.run(state0, step_fn, args.steps, shardings=state_sh)
        dt = time.time() - t0
        if lead:
            print(f"done: {steps} steps in {dt:.1f}s "
                  f"({dt / max(1, steps - (resumed or 0)):.2f}s/step)")
            if sup.monitor.flagged:
                print(f"stragglers flagged: {sup.monitor.flagged}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
