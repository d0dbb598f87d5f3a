"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

The port of ``src/repro/launch/train.py``, with the same flags and one
more, ``--device`` (``cuda``, the default, or ``cpu``). It composes the
stack: arch config → model → AdamW → deterministic data pipeline →
Supervisor (checkpoint/restart, straggler detection, preemption hook) →
optional top-k sparse-allreduce gradient compression (the paper's
technique) → optional publication of sparse parameter deltas for serving
replicas (``launch/serve.py --sync-spool``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --smoke --steps 12 --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch smollm-135m --smoke --compress --mesh 2x2 --device cpu

    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
        -m repro_torch.launch.train --arch smollm-135m --smoke --mesh 2x2 \\
        --device cpu

Its world is the one ``torchrun`` gives it, or a world of one rank (NCCL
on the card, gloo on the CPU; :func:`repro_torch.launch.world.process_world`).
``--mesh auto`` puts every rank on the data dim; ``DxM`` makes a
``("data", "model")`` ``DeviceMesh``. The dense step runs on any world:
params and AdamW state are DTensors placed by ``params_shardings``
(FSDP×TP), each batch is placed by ``batch_shardings``, and checkpoints are
global arrays in one directory, restored onto the same placements. With
``--compress`` params and optimizer state are replicated on every rank and
each rank checkpoints its own state (its residuals are its own). Every
rank trains on the reference's global batch, which rank 0 draws and
broadcasts (a batch's seed is Python's per-process ``hash``); only rank 0
prints and publishes deltas.

The state the Supervisor checkpoints is ``(params, (step, mu, nu))``, or
``(params, (step, mu, nu), ef)`` with ``--compress``: the reference's
``(params, AdamWState[, ef])`` in its leaf order, so a checkpoint crosses
between the packages.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.checkpoint import save_on_signal
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import make_batch
from repro_torch.launch.mesh import make_dp_tp_mesh
from repro_torch.launch.world import process_world
from repro_torch.models import build_model
from repro_torch.models.common import SHAPES, ShapeConfig
from repro_torch.models.layers import use_full_precision
from repro_torch.optim import AdamWState, adamw_init
from repro_torch.runtime import DeltaPublisher, DirTransport, Supervisor
from repro_torch.sharding.params import (batch_shardings, distribute,
                                         gathered, params_shardings)
from repro_torch.train import (TrainHParams, make_compressed_train_step,
                               make_train_step, rank_ef_state)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k", choices=list(SHAPES))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config + tiny shapes (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--mesh", default="auto",
                    help="'auto' (every rank on the data dim) or 'DxM'")
    ap.add_argument("--compress", action="store_true",
                    help="top-k + SpKAdd sparse-allreduce gradient "
                         "compression; composes with a model dim > 1 "
                         "(sparse-DP × TP)")
    ap.add_argument("--k-fraction", type=float, default=0.01)
    ap.add_argument("--schedule", default="gather_kway",
                    choices=["gather_kway", "tree_2way", "ring_2way"])
    ap.add_argument("--model-reduce", default="reduce_scatter",
                    choices=["reduce_scatter", "psum"],
                    help="how TP-partial gradients combine over 'model'")
    ap.add_argument("--publish-deltas", default=None, metavar="DIR",
                    help="spool dir: publish top-k sparse parameter deltas "
                         "for serving replicas (runtime/delta_sync.py); "
                         "serve.py consumes the same dir via --sync-spool")
    ap.add_argument("--sync-every", type=int, default=1,
                    help="publish a delta epoch every N train steps")
    ap.add_argument("--sync-k-fraction", type=float, default=0.01,
                    help="top-k fraction per leaf for delta sparsification "
                         "(1.0 = lossless)")
    ap.add_argument("--sync-window", type=int, default=16,
                    help="resendable ring-buffer depth (epochs)")
    ap.add_argument("--sync-ckpt-every", type=int, default=8,
                    help="epochs between shadow checkpoints — the reload "
                         "target of a beyond-bound subscriber")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the model trains (default: the CUDA card)")
    return ap.parse_args(argv)


def global_batch(cfg, shape, step: int, dev, world: int) -> dict:
    """The reference's batch of ``step``: drawn on rank 0 and broadcast
    when the world has more than one rank."""
    batch = make_batch(cfg, shape, step, device=dev)
    if world > 1:
        for v in batch.values():
            dist.broadcast(v, src=0)
    return batch


def make_mesh(spec: str, world: int, dev):
    """The ``("data", "model")`` mesh of ``--mesh`` (``auto``: every rank
    on the data dim) over the world's ``world`` ranks."""
    if spec == "auto":
        d, t = world, 1
    else:
        d, t = (int(x) for x in spec.split("x"))
    return make_dp_tp_mesh(data=d, model=t, device_type=dev.type)


def run(args) -> int:
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg)
    if args.smoke:
        shape = ShapeConfig("smoke", "train", 64, 4)
        hp = TrainHParams(ce_chunk=32, attn_chunk=32, remat=True,
                          total_steps=args.steps, warmup=10)
    else:
        shape = SHAPES[args.shape]
        hp = TrainHParams(total_steps=args.steps, warmup=100)
    use_full_precision()
    with process_world(args.device) as (rank, world, dev):
        mesh = make_mesh(args.mesh, world, dev)
        lead = rank == 0
        if lead:
            print(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))} over "
                  f"{world} ranks ({dev.type})", flush=True)
        params = model.init(0, device=dev)
        state_sh = None
        if args.compress:
            opt = tuple(adamw_init(params))
            ef = rank_ef_state(params, model_shards=mesh.size(1))
            step_impl = make_compressed_train_step(
                model, mesh, hp, k_fraction=args.k_fraction,
                schedule=args.schedule, model_reduce=args.model_reduce)
            state0 = (params, opt, ef)
        else:
            p_sh = params_shardings(params, mesh)
            params = distribute(params, p_sh)
            opt = tuple(adamw_init(params))  # moments take the placements
            step_impl = make_train_step(model, hp)
            state0 = (params, opt)
            state_sh = (p_sh, (None, p_sh, p_sh))

        def step_fn(state, step):
            batch = global_batch(cfg, shape, step, dev, world)
            if not args.compress:
                batch = distribute(batch, batch_shardings(batch, mesh))
            with obs.span("train.step", step=step, compress=args.compress,
                          schedule=args.schedule if args.compress
                          else "dense", mesh=str(tuple(mesh.shape))):
                if args.compress:
                    p, o, e, metrics = step_impl(
                        state[0], AdamWState(*state[1]), state[2], batch)
                    new_state = (p, tuple(o), e)
                else:
                    p, o, metrics = step_impl(state[0],
                                              AdamWState(*state[1]), batch)
                    new_state = (p, tuple(o))
                if obs.enabled() and dev.type == "cuda":
                    torch.cuda.synchronize(dev)  # the span's honest length
            obs.counter("train.steps").inc()
            if lead and step % 10 == 0:
                lr = metrics.get("lr")
                lr_txt = f" lr {float(lr):.2e}" if lr is not None else ""
                print(f"step {step:5d} loss {float(metrics['loss']):.4f}"
                      f"{lr_txt}", flush=True)
            return new_state

        # compressed state has a different tree ((p, o, ef) vs (p, o)), so
        # the two modes must not share an auto-resume directory; with
        # --compress each rank keeps its own residuals, the dense state is
        # saved as global arrays by all ranks together
        suffix = "_compressed" if args.compress else ""
        ckpt_dir = args.ckpt_dir or os.path.join(
            tempfile.gettempdir(), f"repro_torch_{cfg.arch_id}_ckpt{suffix}")
        if world > 1 and args.compress:
            ckpt_dir = os.path.join(ckpt_dir, f"rank{rank}")
        sup = Supervisor(ckpt_dir, ckpt_every=args.ckpt_every,
                         async_ckpt=True)
        holder = {"state": state0, "step": 0}
        save_on_signal(ckpt_dir, lambda: (holder["step"], holder["state"]))

        publisher = None
        if args.publish_deltas:
            # the gather is a collective: every rank takes part
            full = gathered(params)
        if args.publish_deltas and lead:
            publisher = DeltaPublisher(
                full, DirTransport(args.publish_deltas),
                k_fraction=args.sync_k_fraction,
                window_epochs=args.sync_window,
                ckpt_dir=os.path.join(args.publish_deltas, "ckpt"),
                checkpoint_every=args.sync_ckpt_every, device=dev)

        def tracked_step(state, step):
            new_state = step_fn(state, step)
            holder["state"], holder["step"] = new_state, step + 1
            if args.publish_deltas and (step + 1) % args.sync_every == 0:
                # epochs are derived from the step so a supervisor replay
                # after a restart re-publishes the same epoch numbers it
                # already shipped — the monotonicity check skips them
                epoch = (step + 1) // args.sync_every
                full = gathered(new_state[0])
                if publisher is not None and epoch > publisher.epoch:
                    stats = publisher.publish(full, epoch=epoch)
                    if step % 10 == 0:
                        print(f"delta-sync epoch {stats.epoch}: "
                              f"{stats.bytes}B vs {stats.dense_bytes}B dense "
                              f"({stats.selected} entries)", flush=True)
            return new_state

        state, steps = sup.run(state0, tracked_step, args.steps,
                               shardings=state_sh)
        if lead:
            print(f"finished at step {steps}; restarts={sup.restarts}, "
                  f"stragglers={len(sup.monitor.flagged)}", flush=True)
            if publisher is not None:
                print(f"delta-sync published {publisher.epoch} epochs to "
                      f"{args.publish_deltas}", flush=True)
    return 0


def main(argv=None) -> int:
    return run(parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
