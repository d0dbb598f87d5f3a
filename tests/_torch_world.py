"""Rank bodies of the port's multi-rank parity tests, and their inputs.

The tests start one gloo world a file (``repro_torch.launch.world``); its
ranks run the functions here, which import only numpy, torch and the port
(each rank is a fresh process, so nothing of JAX is loaded there). The
inputs are made from numpy seeds by the builders below, which the pytest
process calls too, to feed the same arrays to the reference under
``jax.vmap``.
"""
import numpy as np

P = 8             # ranks of the allreduce world
MESH_2D = (4, 2)  # its (data, model) layout for the 2-D means
SCHEDULES = ("gather_kway", "tree_2way", "ring_2way")
#: ``sparse_allreduce`` cases: P workers' flat gradients and a top-k each.
#: ``k50`` is ``tests/test_distributed.py``'s; ``n70000`` is not a multiple
#: of the block selector's 4,096.
STREAM_CASES = {
    "k50": dict(size=1000, k=50, selector="global", seed=2),
    "n70000": dict(size=70000, k=3500, selector="block", seed=3),
}
#: The gradient tree of the compressed means: two leaves that compress and
#: one under ``MIN_COMPRESS_ELEMS`` (the dense fallback).
TREE_SHAPES = {"a": (70, 1000), "b": (128, 160), "c": (300,)}
K_FRACTION = 0.05
SELECTORS = ("global", "block")
MODEL_REDUCES = ("reduce_scatter", "psum")
#: The ranks of the world's group whose size is not a power of two.
SUBGROUP = 6


def stream_inputs(case: str, p: int = P) -> np.ndarray:
    """``(p, size)`` f32 gradients of a :data:`STREAM_CASES` case."""
    c = STREAM_CASES[case]
    rng = np.random.default_rng(c["seed"])
    return rng.standard_normal((P, c["size"])).astype(np.float32)[:p]


def tree_inputs(lead: tuple, seed: int, shard: int = 1):
    """Gradients (``lead + shape`` a leaf) and flat residuals (``lead +
    (ceil(size / shard),)``) of :data:`TREE_SHAPES`, f32."""
    rng = np.random.default_rng(seed)
    grads, res = {}, {}
    for name, shape in sorted(TREE_SHAPES.items()):
        n = int(np.prod(shape))
        grads[name] = rng.standard_normal(lead + shape).astype(np.float32)
        res[name] = (0.1 * rng.standard_normal(lead + (-(-n // shard),))
                     ).astype(np.float32)
    return grads, res


def _update(g, case):
    import torch

    from repro_torch.core import topk as T

    c = STREAM_CASES[case]
    x = torch.from_numpy(g)
    return (T.topk_global(x, c["k"]) if c["selector"] == "global"
            else T.topk_block(x, c["k"]))


def _count_received(AR):
    """Wrap the allreduce module's collectives to count the bytes each
    lands in this rank's receive buffers; returns the running tally."""
    tally = [0]
    gather, exchange = AR.all_gather_flat, AR._exchange

    def counted_gather(x, group):
        out = gather(x, group)
        tally[0] += out.numel() * out.element_size()
        return out

    def counted_exchange(send, to, frm, group):
        recv = exchange(send, to, frm, group)
        tally[0] += sum(r.numel() * r.element_size() for r in recv)
        return recv

    AR.all_gather_flat, AR._exchange = counted_gather, counted_exchange
    return tally


def _np_tree(t):
    return {k: v.numpy().copy() for k, v in t.items()}


def allreduce_rank(rank: int, world: int) -> dict:
    """Every allreduce result this rank computes, keyed by case."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import obs
    from repro_torch.core import allreduce as AR

    out = {}
    tally = _count_received(AR)
    obs.reset("allreduce")
    for case in STREAM_CASES:
        u = _update(stream_inputs(case)[rank], case)
        for sched in SCHEDULES:
            before = tally[0]
            out[f"{case}/{sched}"] = AR.sparse_allreduce(
                u, None, sched).numpy()
            out[f"bytes/{case}/{sched}"] = tally[0] - before
            out[f"stream_len/{case}"] = int(u.idx.shape[0])
        out[f"{case}/gather_kway_vec"] = AR.sparse_allreduce(
            u, None, "gather_kway", accumulator="vec").numpy()
    out["obs"] = {k: v["value"] for k, v in obs.snapshot("allreduce").items()}

    # a group of six ranks: no power of two
    six = dist.new_group(ranks=list(range(SUBGROUP)))
    if rank < SUBGROUP:
        u = _update(stream_inputs("k50", SUBGROUP)[rank], "k50")
        for sched in ("gather_kway", "ring_2way"):
            out[f"six/{sched}"] = AR.sparse_allreduce(u, six, sched).numpy()
        try:
            AR.sparse_allreduce(u, six, "tree_2way")
        except ValueError as e:
            out["six/tree_2way_error"] = str(e)

    # the compressed means, DP-only
    grads, res = tree_inputs((P,), seed=11)
    for sel in SELECTORS:
        for sched in SCHEDULES:
            g = {k: torch.from_numpy(v[rank]) for k, v in grads.items()}
            r = {k: torch.from_numpy(v[rank].copy()) for k, v in res.items()}
            mean, new_r = AR.compressed_gradient_mean(
                g, r, None, K_FRACTION, schedule=sched, selector=sel)
            out[f"cgm/{sel}/{sched}"] = (_np_tree(mean), _np_tree(new_r))

    # the compressed means on a (data, model) mesh
    mesh = init_device_mesh("cpu", MESH_2D, mesh_dim_names=("data", "model"))
    d, t = mesh.get_coordinate()
    grads2, res2 = tree_inputs(MESH_2D, seed=12, shard=MESH_2D[1])
    for mr in MODEL_REDUCES:
        for sched in SCHEDULES:
            g = {k: torch.from_numpy(v[d, t]) for k, v in grads2.items()}
            r = {k: torch.from_numpy(v[d, t].copy())
                 for k, v in res2.items()}
            mean, new_r = AR.compressed_gradient_mean_2d(
                g, r, mesh.get_group("data"), mesh.get_group("model"),
                K_FRACTION, schedule=sched, model_reduce=mr)
            out[f"cgm2d/{mr}/{sched}"] = (_np_tree(mean), _np_tree(new_r))
    return out


def fail_on_rank_one(rank: int, world: int) -> None:
    """Rank 1 raises; rank 0 then waits in a barrier that never ends."""
    import torch.distributed as dist

    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.barrier()


# ---------------------------------------------------------------------------
# the compressed train step (tests/test_torch_train_step.py)
# ---------------------------------------------------------------------------

#: The world of the compressed train step: four ranks, laid out as each
#: mesh the reference's ``make_compressed_train_step`` takes under four
#: fake devices.
TRAIN_WORLD = 4
TRAIN_MESHES = {"dp4": (4,), "dp2xtp2": (2, 2)}
TRAIN_ARCH = "smollm-135m"
TRAIN_BATCH = (8, 32)   # global batch: two rows a rank
TRAIN_STEPS = 2
TRAIN_K = 0.05
#: So that the smoke model's weight leaves compress (its largest has
#: 6,144 elements) and its norms take the dense mean.
TRAIN_MIN_COMPRESS = 1024
TRAIN_HP = dict(ce_chunk=16, attn_chunk=16, remat=True, total_steps=10,
                warmup=2)
#: ``tests/test_distributed.py``'s lossless run: k 1.0, the global
#: selector, three steps, no warmup.
FULL_K_HP = dict(ce_chunk=16, attn_chunk=16, remat=False, total_steps=100,
                 warmup=0)
FULL_K_STEPS = 3


def train_batch(step: int, vocab: int = 128) -> dict:
    """The global batch of ``step`` as numpy ``tokens``/``labels``."""
    B, S = TRAIN_BATCH
    toks = np.random.default_rng(100 + step).integers(
        0, vocab, (B, S + 1), dtype=np.int32)
    return {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}


def _train(step_fn, params, opt, ef, steps):
    import torch

    losses, gnorms = [], []
    for s in range(steps):
        batch = {k: torch.from_numpy(v) for k, v in train_batch(s).items()}
        params, opt, ef, met = step_fn(params, opt, ef, batch)
        losses.append(float(met["loss"]))
        gnorms.append(float(met["grad_norm"]))
    return params, opt, ef, losses, gnorms


def compressed_train_rank(rank: int, world: int, params_np) -> dict:
    """This rank's params, AdamW moments, residuals and metrics after
    :data:`TRAIN_STEPS` compressed steps on each mesh of
    :data:`TRAIN_MESHES`, and after the lossless run (``full_k``)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import interop
    from repro_torch import tree as TR
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init
    from repro_torch.train import (TrainHParams, make_compressed_train_step,
                                   rank_ef_state)

    model = build_model(get_smoke_config(TRAIN_ARCH))
    out = {}
    for name, shape in TRAIN_MESHES.items():
        dims = ("data",) if len(shape) == 1 else ("data", "model")
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=dims)
        params = interop.params_from_numpy(params_np, "cpu")
        step = make_compressed_train_step(
            model, mesh, TrainHParams(**TRAIN_HP), k_fraction=TRAIN_K,
            selector="block", min_compress_elems=TRAIN_MIN_COMPRESS)
        ef = rank_ef_state(params, model_shards=shape[-1]
                           if len(shape) == 2 else 1)
        p, o, e, losses, gnorms = _train(step, params, adamw_init(params),
                                         ef, TRAIN_STEPS)
        out[name] = {"coord": tuple(int(c) for c in mesh.get_coordinate()),
                     "params": TR.leaves(interop.params_to_numpy(p)),
                     "mu": TR.leaves(interop.params_to_numpy(o.mu)),
                     "nu": TR.leaves(interop.params_to_numpy(o.nu)),
                     "ef": TR.leaves(interop.params_to_numpy(e)),
                     "loss": losses, "grad_norm": gnorms}
    params = interop.params_from_numpy(params_np, "cpu")
    step = make_compressed_train_step(model, None, TrainHParams(**FULL_K_HP),
                                      k_fraction=1.0, selector="global")
    p, _, _, losses, _ = _train(step, params, adamw_init(params),
                                rank_ef_state(params), FULL_K_STEPS)
    out["full_k"] = {"params": TR.leaves(interop.params_to_numpy(p)),
                     "loss": losses}
    return out


# ---------------------------------------------------------------------------
# sharding (tests/test_torch_sharding.py, tests/test_torch_sharded_step.py)
# ---------------------------------------------------------------------------

#: The meshes whose local shards are held to the slices JAX puts on each
#: device: name -> (axis names, sizes), rank r at position r of the mesh.
PLACEMENT_MESHES = {"2x2": (("data", "model"), (2, 2)),
                    "pod2x2x1": (("pod", "data", "model"), (2, 2, 1))}
#: A tree with a leaf for each kind of rule (stacked, expert, replicated,
#: and one whose dims divide no axis), as names and shapes.
PLACEMENT_TREE = {"embed": (16, 8), "head": (8, 16), "router": (8, 4),
                  "final_ln": (8,), "odd": {"wq": (6, 5)},
                  "layers": {"wq": (3, 8, 12), "wo": (3, 12, 8),
                             "we1": (3, 4, 8, 6), "we2": (3, 4, 6, 8),
                             "ln1": (3, 8)}}


def placement_tree():
    """:data:`PLACEMENT_TREE` filled with distinct f32 values."""
    def fill(node, base=[0]):
        if isinstance(node, dict):
            return {k: fill(v) for k, v in sorted(node.items())}
        n = int(np.prod(node))
        x = np.arange(base[0], base[0] + n, dtype=np.float32).reshape(node)
        base[0] += n
        return x

    return fill(PLACEMENT_TREE, [0])


def placement_rank(rank: int, world: int) -> dict:
    """This rank's local shard of each leaf of :func:`placement_tree`
    placed by ``params_shardings`` on each of :data:`PLACEMENT_MESHES`,
    and whether each gathers back whole."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import interop
    from repro_torch import tree as TR
    from repro_torch.sharding.params import (distribute, gathered,
                                             params_shardings)

    out = {}
    for name, (axes, shape) in PLACEMENT_MESHES.items():
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=axes)
        tree = interop.params_from_numpy(placement_tree(), "cpu")
        placed = distribute(tree, params_shardings(tree, mesh))
        leaves, names, _ = TR.flatten_with_names(placed)
        out[name] = {
            "coord": tuple(int(c) for c in mesh.get_coordinate()),
            "local": {n: x.to_local().numpy().copy()
                      for n, x in zip(names, leaves)},
            "whole": all(torch.equal(a, b) for a, b in zip(
                TR.leaves(gathered(placed)), TR.leaves(tree)))}
    return out


#: The sharded dense step's cases: name -> (mesh (data, model), global
#: batch rows, grad_accum). ``dp2_b3`` takes a batch of 3 on data = 2,
#: which does not divide and so is replicated.
SHARDED_CASES = {"dp2": ((2, 1), 8, 1), "tp2": ((1, 2), 8, 1),
                 "dp2_b3": ((2, 1), 3, 1), "dp2xtp2": ((2, 2), 8, 1),
                 "dp2xtp2_accum2": ((2, 2), 8, 2), "one": ((1, 1), 8, 1),
                 "moe_dp2": ((2, 1), 8, 1), "moe_cap1_dp2": ((2, 1), 8, 1),
                 "moe_cap1_dp2xtp2_accum2": ((2, 2), 8, 2)}
SHARDED_STEPS = 2
#: The MoE cases' model: moonshot's smoke config, with ``capacity_factor``
#: 1.0 in the ``cap1`` cases (its own 8.0 drops nothing), so that the
#: whole batch's capacity binds and assignments drop. Every other case
#: runs :data:`TRAIN_ARCH`'s smoke config.
MOE_ARCH = "moonshot_v1_16b_a3b"
MOE_CAPACITY = {"moe_dp2": None, "moe_cap1_dp2": 1.0,
                "moe_cap1_dp2xtp2_accum2": 1.0}


def sharded_cases(world: int) -> list:
    return [k for k, (m, _, _) in SHARDED_CASES.items()
            if m[0] * m[1] == world]


def case_config(name: str, get_smoke_config):
    """``(arch, smoke config)`` of a :data:`SHARDED_CASES` case, from
    either package's ``get_smoke_config``."""
    import dataclasses

    if name not in MOE_CAPACITY:
        return TRAIN_ARCH, get_smoke_config(TRAIN_ARCH)
    cfg = get_smoke_config(MOE_ARCH)
    if MOE_CAPACITY[name] is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=MOE_CAPACITY[name])
    return MOE_ARCH, cfg


def _count_dense_bytes(ST):
    """Wrap the sharded step's gather and reduce to count the bytes each
    collective is handed (its operand, as an HLO op counts it): a
    gather's local shard, a reduction's whole f32 gradient."""
    tally = {"gather": 0, "reduce": 0}
    gather, reduce = ST._gather, ST._reduce

    def counted_gather(x):
        loc = x.to_local()
        tally["gather"] += loc.numel() * loc.element_size()
        return gather(x)

    def counted_reduce(g, mesh, dims, placements):
        tally["reduce"] += g.numel() * g.element_size()
        return reduce(g, mesh, dims, placements)

    ST._gather, ST._reduce = counted_gather, counted_reduce
    return tally


def _count_drops(MOE):
    """Wrap the MoE's dispatch to count the assignments it drops."""
    tally = [0]
    real = MOE.dispatch

    def counting(*a, **kw):
        d = real(*a, **kw)
        tally[0] += int((~d.keep).sum())
        return d

    MOE.dispatch = counting
    return tally


def sharded_step_rank(rank: int, world: int, params_by_arch: dict) -> dict:
    """Each of this world's :data:`SHARDED_CASES`: the params, moments and
    metrics (the grad norm's bits too) after :data:`SHARDED_STEPS` dense
    steps from its arch's tree in ``params_by_arch``, gathered whole;
    whether the moments are DTensors placed as their params; the bytes one
    step hands to its collectives; the MoE assignments dropped; at world 1
    the plain step's results beside them; at world 2 the bytes of one
    compressed step."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch import interop
    from repro_torch import tree as TR
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.models import moe as MOE
    from repro_torch.optim import adamw_init
    from repro_torch.sharding.params import (distribute, gathered,
                                             params_shardings)
    from repro_torch.train import TrainHParams, make_train_step
    from repro_torch.train import step as ST

    tally = _count_dense_bytes(ST)
    drops = _count_drops(MOE)

    def leaves_np(tree):
        return [x.numpy().copy() for x in TR.leaves(gathered(tree))]

    def run(model, params, grad_accum, rows):
        step = make_train_step(model, TrainHParams(**TRAIN_HP,
                                                   grad_accum=grad_accum))
        drops[0] = 0
        opt = adamw_init(params)
        placed = all(isinstance(m, DTensor) and m.placements == p.placements
                     for p, m in zip(TR.leaves(params) * 2,
                                     TR.leaves(opt.mu) + TR.leaves(opt.nu)))
        met_all, step_bytes = [], None
        for s in range(SHARDED_STEPS):
            batch = {k: torch.from_numpy(v[:rows].copy())
                     for k, v in train_batch(s).items()}
            before = dict(tally)
            params, opt, met = step(params, opt, batch)
            if step_bytes is None:
                step_bytes = {k: tally[k] - before[k] for k in tally}
            met_all.append({k: float(v) for k, v in met.items()}
                           | {"grad_norm_bits": met["grad_norm"].numpy()
                              .tobytes()})
        return {"params": leaves_np(params), "mu": leaves_np(opt.mu),
                "nu": leaves_np(opt.nu), "metrics": met_all,
                "moments_placed": placed, "bytes": step_bytes,
                "dropped": drops[0]}

    out = {}
    for name in sharded_cases(world):
        shape, rows, grad_accum = SHARDED_CASES[name]
        arch, cfg = case_config(name, get_smoke_config)
        model = build_model(cfg)
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        plain = interop.params_from_numpy(params_by_arch[arch], "cpu")
        params = distribute(plain, params_shardings(plain, mesh))
        out[name] = run(model, params, grad_accum, rows)
        batch = {k: torch.from_numpy(v[:rows].copy())
                 for k, v in train_batch(0).items()}
        local, split = ST._local_rows(batch, mesh, grad_accum)
        out[name]["split"] = split
        out[name]["local_rows"] = int(local["tokens"].shape[0])
        if world == 1:
            out[name]["plain"] = run(model, plain, grad_accum, rows)
    if world == 2:
        out["compressed_bytes"] = _compressed_step_bytes(
            build_model(get_smoke_config(TRAIN_ARCH)),
            params_by_arch[TRAIN_ARCH])
    return out


def _compressed_step_bytes(model, params_np) -> int:
    """The bytes one compressed step (k :data:`TRAIN_K`, the block
    selector, ``gather_kway``) lands in this rank's receive buffers."""
    import torch

    from repro_torch import interop
    from repro_torch.core import allreduce as AR
    from repro_torch.optim import adamw_init
    from repro_torch.train import (TrainHParams, make_compressed_train_step,
                                   rank_ef_state)

    tally = _count_received(AR)
    params = interop.params_from_numpy(params_np, "cpu")
    step = make_compressed_train_step(
        model, None, TrainHParams(**TRAIN_HP), k_fraction=TRAIN_K,
        selector="block", min_compress_elems=TRAIN_MIN_COMPRESS)
    batch = {k: torch.from_numpy(v) for k, v in train_batch(0).items()}
    step(params, adamw_init(params), rank_ef_state(params), batch)
    return tally[0]


#: The elastic checkpoint's array: saved on a 4-rank data mesh, restored
#: onto these (mesh, spec) layouts.
ELASTIC_RESTORES = {"2x2": ((2, 2), ("data", "model")),
                    "4x1": ((4, 1), ("data", "model"))}


def elastic_array() -> np.ndarray:
    return np.arange(64, dtype=np.float32).reshape(8, 8)


#: ``local_region``'s cases on a (2, 2) mesh: global shape -> placements
#: (``S`` a mesh dim's tensor dim, ``None`` replicated). Shapes that do
#: not divide leave short and empty chunks.
REGION_CASES = {"even": ((8, 6), (0, 1)), "nested": ((8, 3), (0, 0)),
                "uneven": ((5, 3), (0, 1)), "short": ((3, 1), (0, 0)),
                "replicated": ((4, 4), (None, 0)), "scalar": ((), (None,
                                                                   None))}


def local_regions() -> dict:
    """For each of :data:`REGION_CASES` on a (2, 2) mesh: whether
    ``local_region``'s slice of the global array equals the local shard
    ``distribute_tensor`` gives this rank."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.sharding.params import local_region

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    out = {}
    for name, (shape, dims) in REGION_CASES.items():
        pl = [Replicate() if d is None else Shard(d) for d in dims]
        x = torch.arange(int(np.prod(shape)),
                         dtype=torch.float32).reshape(shape)
        want = distribute_tensor(x, mesh, pl, src_data_rank=None).to_local()
        got = x[local_region(shape, mesh, pl)]
        out[name] = bool(got.shape == want.shape and torch.equal(got, want))
    return out


def elastic_rank(rank: int, world: int, port_dir: str, ref_dir: str):
    """Save :func:`elastic_array` placed ``P('data')`` on a ``(4,)`` mesh
    into ``port_dir``; restore it and the reference's save in ``ref_dir``
    onto each of :data:`ELASTIC_RESTORES` (local shard, placements, the
    whole) and onto plain tensors; the leaves the save copied to this
    rank's host; :func:`local_regions`."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint import checkpoint as CK
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.sharding.api import NamedSharding, P
    from repro_torch.sharding.params import distribute

    x = torch.from_numpy(elastic_array())
    mesh_a = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
    xa = distribute({"x": x}, {"x": NamedSharding(mesh_a, P("data"))})
    copies, to_numpy = [0], CK._to_numpy

    def counted(leaf):
        copies[0] += 1
        return to_numpy(leaf)

    CK._to_numpy = counted
    try:
        save_checkpoint(port_dir, 1, xa)
    finally:
        CK._to_numpy = to_numpy
    out = {"host_copies": copies[0], "regions": local_regions()}
    for src, path in (("port", port_dir), ("reference", ref_dir)):
        for name, (shape, spec) in ELASTIC_RESTORES.items():
            mesh = init_device_mesh("cpu", shape,
                                    mesh_dim_names=("data", "model"))
            got = restore_checkpoint(path, 1, {"x": x},
                                     {"x": NamedSharding(mesh, P(*spec))})
            out[f"{src}/{name}"] = {
                "local": got["x"].to_local().numpy().copy(),
                "placements": [repr(p) for p in got["x"].placements],
                "whole": got["x"].full_tensor().numpy().copy()}
        plain = restore_checkpoint(path, 1, {"x": x})["x"]
        out[f"{src}/plain"] = (type(plain).__name__, plain.numpy().copy())
    return out


def sharded_runtime_rank(rank: int, world: int, params_np, frames_dir: str):
    """On a world of two: the publisher with and without a mesh (frames,
    the residuals' placements); the preemption save of a sharded and a
    plain state; an ``AsyncCheckpointer`` of a sharded state; and a
    ``Supervisor`` that saves on a (2, 1) mesh and resumes on (1, 2)."""
    import os

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch import interop
    from repro_torch import tree as TR
    from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                        preemption_save, restore_checkpoint)
    from repro_torch.runtime import DeltaPublisher, InProcTransport, Supervisor
    from repro_torch.sharding.params import (distribute, gathered,
                                             params_shardings)

    out = {}
    # the publisher: two epochs, the same params, with and without a mesh
    frames = {}
    for name, shape in (("none", None), ("2x1", (2, 1)), ("1x2", (1, 2))):
        mesh = (None if shape is None else init_device_mesh(
            "cpu", shape, mesh_dim_names=("data", "model")))
        wire = InProcTransport()
        pub = DeltaPublisher(interop.params_from_numpy(params_np, "cpu"),
                             wire, k_fraction=0.05, selector="block",
                             device="cpu", mesh=mesh)
        for epoch in (1, 2):
            pub.publish(interop.params_from_numpy(
                publish_params(params_np, epoch), "cpu"))
        frames[name] = wire.poll()
        out[f"ef_placements/{name}"] = (
            None if pub.ef_placements is None
            else sorted({str(p) for p in pub.ef_placements}))
    out["frames"] = frames

    # the preemption save: a sharded state writes nothing and issues no
    # collective; a plain one writes
    mesh = init_device_mesh("cpu", (2, 1), mesh_dim_names=("data", "model"))
    plain = interop.params_from_numpy(params_np, "cpu")
    sharded = distribute(plain, params_shardings(plain, mesh))
    real = (dist.all_gather, dist.barrier, DTensor.full_tensor)

    def no_collective(*a, **kw):
        raise AssertionError("a collective in the signal handler")

    rank_dir = os.path.join(frames_dir, f"preempt{rank}")
    dist.all_gather = dist.barrier = DTensor.full_tensor = no_collective
    try:
        out["preempt_sharded"] = preemption_save(rank_dir,
                                                 lambda: (3, sharded))
    finally:
        dist.all_gather, dist.barrier, DTensor.full_tensor = real
    out["preempt_sharded_wrote"] = latest_step(rank_dir)
    out["preempt_plain"] = preemption_save(rank_dir, lambda: (4, plain))
    out["preempt_plain_wrote"] = latest_step(rank_dir)

    # the async checkpointer gathers on this thread; rank 0 writes
    async_dir = os.path.join(frames_dir, "async")
    ck = AsyncCheckpointer(async_dir)
    ck.save(5, sharded)
    ck.close()
    dist.barrier()
    out["async_steps"] = latest_step(async_dir)
    back = restore_checkpoint(async_dir, 5, plain)
    out["async_equal"] = all(torch.equal(a, b) for a, b in zip(
        TR.leaves(back), TR.leaves(plain)))

    # the supervisor: two steps saved on (2, 1), resumed to four on (1, 2)
    sup_dir = os.path.join(frames_dir, "supervisor")

    def bump(state, step):
        return TR.tree_map(lambda x: x + 1.0, state)

    Supervisor(sup_dir, ckpt_every=2).run(sharded, bump, 2)
    mesh_b = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
    sh_b = params_shardings(plain, mesh_b)
    state, steps = Supervisor(sup_dir, ckpt_every=2).run(
        distribute(plain, sh_b), bump, 4, shardings=sh_b)
    out["supervisor_steps"] = steps
    out["supervisor_placements"] = [
        (str(a.placements), str(b.placements))
        for a, b in zip(TR.leaves(state), TR.leaves(distribute(plain, sh_b)))]
    out["supervisor_values"] = [x.numpy().copy()
                                for x in TR.leaves(gathered(state))]
    return out


def publish_params(params_np, epoch: int):
    """The publisher's params at ``epoch``: ``params_np`` plus a seeded
    step of each leaf."""
    rng = np.random.default_rng(300 + epoch)

    def step(node):
        if isinstance(node, dict):
            return {k: step(v) for k, v in sorted(node.items())}
        return (node + 0.01 * rng.standard_normal(node.shape)
                ).astype(node.dtype)

    return step(params_np)


def cost_rank(rank: int, world: int, params_np) -> dict:
    """One dense step of the smoke config on a (2, 2) ``("data",
    "model")`` mesh under ``launch/hlo_analysis.analyze_step``, from the
    reference's tree on :func:`train_batch` 0, on real CPU tensors and on
    fake tensors of the same shapes: each run's ``Roofline.to_dict()``."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import interop
    from repro_torch.compat import fake_tensor_mode
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.hlo_analysis import analyze_step
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init
    from repro_torch.sharding.params import distribute, params_shardings
    from repro_torch.train import TrainHParams, make_train_step

    model = build_model(get_smoke_config(TRAIN_ARCH))
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    step = make_train_step(model, TrainHParams(**TRAIN_HP))

    def run(plain, batch):
        params = distribute(plain, params_shardings(plain, mesh))
        return analyze_step(step, params, adamw_init(params), batch)[1]

    real = run(interop.params_from_numpy(params_np, "cpu"),
               {k: torch.from_numpy(v) for k, v in train_batch(0).items()})
    with fake_tensor_mode()():
        fake = run(model.init(0, device="cpu"),
                   {k: torch.empty(v.shape, dtype=torch.int32)
                    for k, v in train_batch(0).items()})
    return {"real": real.to_dict(), "fake": fake.to_dict()}
