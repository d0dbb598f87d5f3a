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
