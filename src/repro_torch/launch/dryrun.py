"""Multi-pod dry-run: trace every (arch × shape × mesh) cell on a fake world.

The counterpart of ``src/repro/launch/dryrun.py``, which lowers and
compiles each cell for 512 placeholder devices. Here each cell's step runs
once under ``FakeTensorMode`` (shapes and dtypes, no memory, no data) as
rank 0 of a *fake* process group of 256 (16 × 16) or 512 (2 × 16 × 16)
ranks, whose collectives move nothing, through the DTensor path of
``repro_torch.sharding`` — so no card and no other process is needed:

- ``train``: the f32 parameters placed by ``params_shardings``, AdamW state
  on their placements, the global batch by ``batch_shardings``, one
  ``make_train_step`` step: each layer casts and gathers its weights where
  it uses them, the dense decoder's attention, MLP, embedding and loss on
  their ``model`` shards (the reference's activation sums over ``model``
  among the collectives), the MoE's experts on theirs over this rank's
  block of the dispatch buffer's capacity (its tokens moved by a
  reduce-scatter and an all-gather over ``data``), each use's gradient
  reduced into its leaf's shard, AdamW on shards.
- ``prefill`` / ``decode``: bf16 parameters (:func:`serve_param_sds`)
  placed by :func:`serve_shardings` (TP-only: no ``data`` axis), the batch
  and the caches (``cache_shardings``) on theirs, one ``make_prefill_step``
  / ``make_decode_step`` step: each rank runs its ``model`` shard on its
  rows and its part of the caches (a decode step moves no weight: the
  token's activations, the logits' vocabulary shards and, over a cache
  split along ``head_dim``, the scores' sums over ``model``).

For each cell :func:`run_cell` records what ``launch/hlo_analysis.py``
counts of that one step on one rank (FLOPs, unfused HBM bytes, collective
operand bytes by kind, the arguments' bytes and the step's peak of its
own), the analytic useful FLOPs (:func:`model_flops`) and ``trace_s``,
the seconds the trace took (it stands for the reference's ``lower_s`` and
``compile_s``). ``--sp`` sets ``use_sp`` on every cell's config, as the
reference's does: the ``TransformerLM`` families' train step and prefill
then split the residual stream's sequence over ``model`` (the reference's
``seq_sp``: each rank's block of S / 16 positions, the weights gathered
whole at use, k and v all-gathered along the sequence); decode and the
Mamba2, Zamba2 and Whisper cells read no ``use_sp`` and are the cells
without it.

One process holds one default process group: the dry-run starts its own
fake world and refuses to run where one already exists (the counterpart of
the reference's refusal once a jax backend exists).

Usage:
  python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun_torch.json
  python -m repro_torch.launch.dryrun --all --mesh both --sp
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch import compat
from repro_torch import tree as _tree
from repro_torch.configs import ARCHS, get_config, supports_shape
from repro_torch.data.synthetic import decode_inputs, input_specs
from repro_torch.launch.hlo_analysis import analyze_step
from repro_torch.launch.mesh import chips, production_mesh_shape
from repro_torch.models import build_model, moe
from repro_torch.models.common import SHAPES
from repro_torch.optim import adamw_init
from repro_torch.sharding.api import NamedSharding, mesh_axes
from repro_torch.sharding.params import (_map_caches, _validated,
                                         batch_shardings, cache_shardings,
                                         distribute, param_spec,
                                         params_shardings)
from repro_torch.train import (TrainHParams, make_decode_step,
                               make_prefill_step, make_train_step)

MESH_NAMES = {False: "16x16", True: "2x16x16"}


@contextlib.contextmanager
def fake_world(multi_pod: bool):
    """This process as rank 0 of a fake world the size of the production
    mesh, and that mesh over it (a ``DeviceMesh`` of ``cpu`` ranks).
    Refuses where a default process group already exists."""
    if dist.is_initialized():
        raise RuntimeError(
            "repro_torch.launch.dryrun needs its own fake world of "
            f"{chips(production_mesh_shape(multi_pod=multi_pod))} ranks, but "
            "this process already has a default process group (one process "
            "holds one). Run the dry-run in a fresh process (`python -m "
            "repro_torch.launch.dryrun ...`).")
    from torch.distributed.device_mesh import init_device_mesh

    shape = production_mesh_shape(multi_pod=multi_pod)
    dist.init_process_group("fake", store=compat.fake_store()(), rank=0,
                            world_size=chips(shape))
    try:
        yield init_device_mesh("cpu", tuple(shape.shape),
                               mesh_dim_names=tuple(shape.axis_names))
    finally:
        dist.destroy_process_group()


def serve_param_sds(params_sds):
    """Serving stores params in bf16 (inference convention): ``meta``
    tensors of each leaf's shape, floating leaves in bf16."""
    def cast(leaf):
        dtype = torch.bfloat16 if leaf.dtype.is_floating_point else leaf.dtype
        return torch.empty(leaf.shape, dtype=dtype, device="meta")

    return _tree.tree_map(cast, params_sds)


def serve_shardings(params_sds, mesh):
    """TP-only (no FSDP gather per token): each leaf's ``param_spec`` with
    every ``data`` / ``("pod", "data")`` entry dropped, validated again; a
    tree of ``NamedSharding`` (its ``placements`` are DTensor's, through
    ``spec_placements``)."""
    def spec(name, leaf):
        p = param_spec(name, leaf, mesh)
        dp = ("pod", "data") if "pod" in mesh_axes(mesh) else "data"
        cleaned = tuple(None if ax == dp or ax == "data" or
                        (isinstance(ax, tuple) and "data" in ax) else ax
                        for ax in (tuple(p) + (None,) * (len(leaf.shape)
                                                         - len(p))))
        return NamedSharding(mesh, _validated(cleaned, tuple(leaf.shape),
                                              mesh))

    leaves, names, treedef = _tree.flatten_with_names(params_sds)
    return _tree.unflatten(treedef, [spec(n, x)
                                     for n, x in zip(names, leaves)])


def _fake_like(leaf):
    """A fake ``cpu`` tensor of ``leaf``'s shape and dtype (inside the
    cell's ``FakeTensorMode``)."""
    return torch.empty(leaf.shape, dtype=leaf.dtype, device="cpu")


def _place_caches(caches, shardings):
    """The cache tree placed leaf by leaf on its shardings (both trees in
    the models' cache structure)."""
    flat_sh = []
    _map_caches(flat_sh.append, shardings)
    it = iter(flat_sh)
    return _map_caches(lambda x: distribute(x, next(it)), caches)


def _moe_combine_shape(contrib):
    """The MoE combine's result as a shape and a type only: on fake
    tensors neither its kernel nor its plain version runs."""
    T, _, d = contrib.shape
    return contrib.new_empty((T, d))


@contextlib.contextmanager
def _shape_only_combine():
    """The MoE combine as :func:`_moe_combine_shape` for the duration of a
    fake trace."""
    real = moe.moe_combine_raw
    moe.moe_combine_raw = _moe_combine_shape
    try:
        yield
    finally:
        moe.moe_combine_raw = real


def lower_cell(arch: str, shape_name: str, mesh,
               hp: TrainHParams | None = None,
               attn_chunk_decode: int = 4096, use_sp: bool = False):
    """``(step, args, cfg, shape)``: the cell's step and its arguments,
    fake tensors placed on ``mesh``, the config with ``use_sp`` set when
    asked. Call inside a ``FakeTensorMode``."""
    cfg = get_config(arch)
    if use_sp:
        cfg = dataclasses.replace(cfg, use_sp=True)
    shape = SHAPES[shape_name]
    model = build_model(cfg)
    hp = hp or TrainHParams()
    params = model.init(0, device="cpu")
    batch = {k: _fake_like(v) for k, v in input_specs(cfg, shape).items()}
    batch = distribute(batch, batch_shardings(batch, mesh))
    if shape.kind == "train":
        params = distribute(params, params_shardings(params, mesh))
        return (make_train_step(model, hp),
                (params, adamw_init(params), batch), cfg, shape)
    sp = _tree.tree_map(_fake_like, serve_param_sds(params))
    del params
    sp = distribute(sp, serve_shardings(sp, mesh))
    if shape.kind == "prefill":
        step = make_prefill_step(model, attn_chunk=hp.attn_chunk)
        return step, (sp, batch), cfg, shape
    cache_meta, tok_meta = decode_inputs(cfg, shape, model)
    caches = _map_caches(_fake_like, cache_meta)
    caches = _place_caches(caches, cache_shardings(caches, cfg, mesh,
                                                   shape.global_batch))
    tok = distribute({"tok": _fake_like(tok_meta)},
                     batch_shardings({"tok": tok_meta}, mesh))["tok"]
    step = make_decode_step(model, attn_chunk=attn_chunk_decode)
    return step, (sp, caches, tok), cfg, shape


def model_flops(cfg, shape, n_chips: int) -> float:
    """Analytic useful FLOPs per device per step (6ND / 2ND convention,
    embedding-lookup params excluded, active params for MoE)."""
    n = cfg.active_param_count() - cfg.vocab * cfg.d_model
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6 if shape.kind == "train" else 2
    return mult * n * tokens / n_chips


def run_cell(arch: str, shape_name: str, mesh,
             hp: TrainHParams | None = None, use_sp: bool = False) -> dict:
    """The record of one cell on ``mesh`` (a fake world's, from
    :func:`fake_world`)."""
    t0 = time.time()
    with compat.fake_tensor_mode()(), _shape_only_combine():
        step, args, cfg, shape = lower_cell(arch, shape_name, mesh, hp,
                                            use_sp=use_sp)
        _, roof = analyze_step(step, *args)
    trace_s = time.time() - t0
    n_chips = chips(mesh)
    mf = model_flops(cfg, shape, n_chips)
    return {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if n_chips == 512 else "16x16",
        "chips": n_chips,
        "status": "ok",
        "trace_s": round(trace_s, 1),
        "sp": use_sp,
        "model_flops_per_chip": mf,
        "useful_flops_ratio": mf / roof.flops if roof.flops else None,
        **roof.to_dict(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None, help="append JSON records here")
    ap.add_argument("--attn-chunk", type=int, default=1024)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--accum-dtype", default="float32")
    ap.add_argument("--sp", action="store_true",
                    help="sequence parallelism (use_sp): the decoders' "
                         "train step and prefill split the residual "
                         "stream's sequence over 'model'")
    ap.add_argument("--ce-chunk", type=int, default=512)
    ap.add_argument("--print-hlo-collectives", action="store_true",
                    help="print each cell's counted collectives by kind")
    args = ap.parse_args(argv)

    hp = TrainHParams(attn_chunk=args.attn_chunk, ce_chunk=args.ce_chunk,
                      grad_accum=args.grad_accum,
                      accum_dtype=args.accum_dtype)

    archs = [args.arch] if args.arch else ARCHS
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    cells = []
    for a in archs:
        for s in shapes:
            if not supports_shape(a, s):
                print(f"SKIP {a} × {s} (documented in DESIGN.md §6)")
                continue
            cells.append((a, s))

    records = []
    for mp in meshes:
        with fake_world(mp) as mesh:
            for a, s in cells:
                label = f"{a} × {s} × {MESH_NAMES[mp]}"
                try:
                    rec = run_cell(a, s, mesh, hp, use_sp=args.sp)
                    peak = rec["arg_bytes"] + rec["temp_bytes"]
                    print(f"OK   {label}: flops/chip={rec['flops']:.3e} "
                          f"hbm={rec['hbm_bytes']:.3e} "
                          f"coll={rec['coll_bytes']:.3e} "
                          f"bottleneck={rec['bottleneck']} "
                          f"mem={peak / 2**30:.2f}GiB "
                          f"(trace {rec['trace_s']}s)", flush=True)
                    if args.print_hlo_collectives:
                        for kind, b in sorted(rec["coll_by_kind"].items()):
                            print(f"     {kind:15s} {b:.6e} B in "
                                  f"{rec['coll_counts'][kind]} call(s)")
                except Exception as e:  # a cell's failure is its record
                    traceback.print_exc()
                    rec = {"arch": a, "shape": s, "mesh": MESH_NAMES[mp],
                           "status": f"FAIL: {type(e).__name__}: {e}"}
                    print(f"FAIL {label}: {e}", flush=True)
                records.append(rec)

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        existing = []
        if os.path.exists(args.out):
            with open(args.out) as f:
                existing = json.load(f)
        # replace same-key records
        keys = {(r["arch"], r["shape"], r["mesh"]) for r in records}
        existing = [r for r in existing
                    if (r["arch"], r["shape"], r["mesh"]) not in keys]
        with open(args.out, "w") as f:
            json.dump(existing + records, f, indent=1)
        print(f"wrote {len(records)} records to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
