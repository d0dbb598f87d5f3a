"""Static-shape sparse containers for SpKAdd on PyTorch.

The port of ``src/repro/core/sparse.py``. Sparse matrices are stored as
*padded* COO: fixed-capacity key/value tensors plus an ``nnz`` tensor.
Invalid slots carry the sentinel key ``m*n`` and a value of exactly 0.0,
and every function here keeps that invariant. Keys are linearized in CSC
order (``key = col * m + row``), so a sorted PaddedCOO is sorted the way the
paper's ColAdd expects.

Shapes stay static, as in the reference: every geometry depends only on
capacities, and nothing on the main path reads ``nnz`` or any other device
value back to the host. Functions act on the last axis, so a leading batch
dimension (the reference's ``vmap``) is written out and carried through.

Entry points follow their input tensors' device. Constructors
(:func:`make_empty`, :func:`from_coords`) take ``device=None``, which means
the CUDA card, and raise when no card is present unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

import contextlib
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.kernels import xla_float
from repro_torch.kernels.segment import segment_fold
from repro_torch.obs import metrics as _metrics


def next_pow2(x: int) -> int:
    """Smallest power of two >= x (>= 1). Shared by capacity bucketing
    (engine) and chunk sizing (kernel wrappers)."""
    p = 1
    while p < x:
        p *= 2
    return p


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card. Raises when CUDA is asked for and no
    card is present (pass ``device="cpu"`` to build on the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to build tensors on the CPU")
    return dev


#: Counter of stable key sorts issued through :func:`stable_argsort` and
#: :func:`stable_sort`, on the obs registry under the reference's name. The
#: one-pass partitioned regimes promise exactly one stable sort per engine
#: call (the canonical plan's), the hash regime exactly one (its
#: compaction), and tests assert the delta across a call.
SORT_COUNTER_NAME = "sparse.stable_argsort.calls"
_SORT_COUNTER = _metrics.counter(SORT_COUNTER_NAME)
#: Depth of :func:`uncounted_sorts` blocks open (sorts count at 0).
_UNCOUNTED = [0]


def sort_calls() -> int:
    """Number of counted stable sorts so far."""
    return _SORT_COUNTER.value


@contextlib.contextmanager
def uncounted_sorts():
    """Sorts issued inside the block are not counted: a forward recomputed
    in backward (``torch.utils.checkpoint``) repeats sorts its first run
    counted, where the reference, which counts at trace time, counts
    once."""
    _UNCOUNTED[0] += 1
    try:
        yield
    finally:
        _UNCOUNTED[0] -= 1


def _count_sort() -> None:
    if not _UNCOUNTED[0]:
        _SORT_COUNTER.inc()


def stable_argsort(keys: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The *one* stable key sort every canonical path goes through
    (counted; see :func:`sort_calls`). Returns int64 indices."""
    _count_sort()
    return torch.argsort(keys, dim=dim, stable=True)


def stable_sort(keys: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Counted stable *value* sort — :func:`stable_argsort`'s twin for the
    key-only consumers (symbolic phase, oracles)."""
    _count_sort()
    return torch.sort(keys, dim=dim, stable=True).values


def sentinel_key(shape: Tuple[int, int]) -> int:
    """Key strictly greater than any valid linearized (row, col)."""
    m, n = shape
    return m * n


class PaddedCOO(NamedTuple):
    """Fixed-capacity COO sparse matrix (CSC-ordered keys).

    Fields
    ------
    keys : int32[..., cap]  linearized ``col*m + row``; ``m*n`` marks padding
    vals : float[..., cap]  0.0 in padding slots (invariant)
    nnz  : int32[...]       number of valid entries
    shape: (m, n)           static logical shape

    A leading batch dimension on every leaf makes a *batched* PaddedCOO
    (``engine.stack_collections``).
    """

    keys: torch.Tensor
    vals: torch.Tensor
    nnz: torch.Tensor
    shape: Tuple[int, int]

    @property
    def cap(self) -> int:
        return self.keys.shape[-1]

    @property
    def rows(self) -> torch.Tensor:
        m, _ = self.shape
        return torch.where(self.valid_mask(), self.keys % m, m)

    @property
    def cols(self) -> torch.Tensor:
        m, n = self.shape
        return torch.where(self.valid_mask(), self.keys // m, n)

    def valid_mask(self) -> torch.Tensor:
        return self.keys != sentinel_key(self.shape)

    def to_dense(self) -> torch.Tensor:
        """Dense ``(m, n)``: duplicate keys fold in stream order from +0.0
        (the reference's in-order ``.at[].add``), through one counted stable
        sort and the ordered segment fold."""
        m, n = self.shape
        valid = self.valid_mask()
        # the reference adds padding (as 0.0) into key 0; the port gives it
        # the dropped id m*n instead, which leaves every sum's bits as they
        # are (see segment_fold) and sorts the padding behind the real keys
        k = torch.where(valid, self.keys, m * n).to(torch.int32)
        v = torch.where(valid, self.vals, 0.0)
        order = stable_argsort(k)
        flat = segment_fold(v[order], k[order], m * n)
        return flat.reshape(n, m).T  # keys are col-major


def make_empty(shape: Tuple[int, int], cap: int, dtype=torch.float32,
               device=None) -> PaddedCOO:
    dev = resolve_device(device)
    return PaddedCOO(
        keys=torch.full((cap,), sentinel_key(shape), dtype=torch.int32,
                        device=dev),
        vals=torch.zeros((cap,), dtype=dtype, device=dev),
        nnz=torch.zeros((), dtype=torch.int32, device=dev),
        shape=shape,
    )


def from_coords(rows, cols, vals, shape: Tuple[int, int], nnz=None,
                device=None) -> PaddedCOO:
    """Build from (row, col, val) arrays (numpy or tensors, with any leading
    batch dimensions); all entries are valid unless ``nnz`` is given, in
    which case trailing slots are padded out."""
    dev = resolve_device(device)
    m, n = shape
    rows = torch.as_tensor(rows, device=dev)
    cols = torch.as_tensor(cols, device=dev)
    vals = torch.as_tensor(vals, device=dev)
    cap = rows.shape[-1]
    keys = cols.to(torch.int32) * m + rows.to(torch.int32)
    if nnz is None:
        nnz = torch.full(rows.shape[:-1], cap, dtype=torch.int32, device=dev)
    else:
        nnz = torch.as_tensor(nnz, dtype=torch.int32, device=dev)
    valid = torch.arange(cap, device=dev) < nnz.unsqueeze(-1)
    keys = torch.where(valid, keys, sentinel_key(shape))
    vals = torch.where(valid, vals, 0.0)
    return PaddedCOO(keys=keys, vals=vals, nnz=nnz, shape=shape)


def top_k_abs(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest ``|x|`` along the last axis, largest
    first, ties to the lower index: the rule of the reference's
    ``lax.top_k`` (``torch.topk`` breaks ties in another order).

    A stable descending sort, not counted by :func:`sort_calls`: the
    reference's ``top_k`` is not a counted sort either."""
    order = torch.sort(x.abs(), dim=-1, descending=True, stable=True).indices
    return order[..., :k]


def from_dense(dense: torch.Tensor, cap: int) -> PaddedCOO:
    """Dense -> PaddedCOO keeping at most ``cap`` nonzeros (all, if they fit).

    Selection is by |value| (:func:`top_k_abs`), so truncation (if any)
    keeps the heavy entries, ties to the lower key; with
    ``cap >= nnz(dense)`` this is exact.
    """
    m, n = dense.shape
    flat = dense.T.reshape(-1)  # col-major to match keys
    k = min(cap, m * n)
    idx = top_k_abs(flat, k)
    v = flat[idx]
    valid = xla_float.flush(v) != 0.0  # XLA's compare: a subnormal is 0
    keys = torch.where(valid, idx.to(torch.int32), sentinel_key((m, n)))
    vals = torch.where(valid, v, 0.0)
    nnz = valid.sum(dtype=torch.int32)
    order = stable_argsort(keys)
    out = PaddedCOO(keys=keys[order], vals=vals[order], nnz=nnz, shape=(m, n))
    if cap > k:
        out = with_capacity(out, cap)
    return out


def sort_by_key(a: PaddedCOO) -> PaddedCOO:
    order = stable_argsort(a.keys)
    return a._replace(keys=torch.gather(a.keys, -1, order),
                      vals=torch.gather(a.vals, -1, order))


class CompressPlan(NamedTuple):
    """The *structural* half of :func:`compress` — everything that depends
    on keys only, shared by every engine regime so they all emit the same
    canonical key layout."""

    order: torch.Tensor     # int64[..., cap]  stable argsort of the keys
    gid: torch.Tensor       # int32[..., cap]  output group id per sorted slot
    is_new: torch.Tensor    # bool[..., cap]   first-occurrence flag
    out_keys: torch.Tensor  # int32[..., cap]  canonical key layout
    nnz: torch.Tensor       # int32[...]       structural distinct-key count


def _first_flags(k_s: torch.Tensor) -> torch.Tensor:
    first = torch.ones(k_s.shape, dtype=torch.bool, device=k_s.device)
    first[..., 1:] = k_s[..., 1:] != k_s[..., :-1]
    return first


def compress_plan(keys: torch.Tensor, shape: Tuple[int, int]) -> CompressPlan:
    """Sort keys, flag first occurrences, and lay out the canonical output
    key array (paper Alg. 6's symbolic phase, vectorized)."""
    cap = keys.shape[-1]
    sent = sentinel_key(shape)
    order = stable_argsort(keys)
    k_s = torch.gather(keys, -1, order)
    is_new = _first_flags(k_s) & (k_s != sent)
    # group id for every slot; padding inherits the last group but adds 0.0
    gid = torch.clamp(torch.cumsum(is_new, -1, dtype=torch.int32) - 1, 0,
                      max(cap - 1, 0))
    out_keys = torch.full(keys.shape[:-1] + (cap + 1,), sent,
                          dtype=torch.int32, device=keys.device)
    scatter_idx = torch.where(is_new, gid, cap).long()  # slot cap is dropped
    out_keys.scatter_(-1, scatter_idx, k_s.to(torch.int32))
    nnz = is_new.sum(-1, dtype=torch.int32)
    return CompressPlan(order=order, gid=gid, is_new=is_new,
                        out_keys=out_keys[..., :cap], nnz=nnz)


class PartitionSteps(NamedTuple):
    """Flattened (chunk, part) schedule of the one-pass partitioned launch.

    Step ``t`` reads input chunk ``chunk_id[..., t]`` and accumulates into
    part ``part_id[..., t]`` (``part_id == parts`` marks a padding step).
    Both tables are non-decreasing along the last axis, so a part's steps
    are one contiguous range, which is how each CUDA block finds its own.
    """

    chunk_id: torch.Tensor  # int32[..., max_steps]
    part_id: torch.Tensor   # int32[..., max_steps]


def partition_max_steps(num_chunks: int, parts: int) -> int:
    """Static step-count bound: every chunk contributes >= 1 step, each
    part transition inside a chunk and each empty part adds at most one."""
    return num_chunks + parts


def partition_steps(keys_sorted: torch.Tensor, *, mn: int, part_elems: int,
                    parts: int, chunk: int) -> PartitionSteps:
    """Build the (chunk, part) step schedule for a *sorted* padded stream.

    ``keys_sorted`` is ``(cap_pad,)`` or ``(B, cap_pad)``, ascending with
    sentinels (``>= mn``) at the tail, ``cap_pad`` a multiple of ``chunk``.
    Parts are key-aligned, so each part covers the element range
    ``[lo_p, hi_p)`` found by binary search on the device. Empty parts get
    one step that re-reads the previous step's chunk so their tile is
    visited and zeroed; padding steps repeat the last real chunk with
    ``part_id = parts``.
    """
    squeeze = keys_sorted.dim() == 1
    ks = (keys_sorted[None] if squeeze else keys_sorted).to(torch.int32)
    ks = ks.contiguous()
    B, cap_pad = ks.shape
    dev = ks.device
    num_chunks = cap_pad // chunk
    max_steps = partition_max_steps(num_chunks, parts)
    # first sentinel position == number of valid keys; bounds clipped there
    # so a sentinel landing inside the last part's key range is never
    # scheduled as payload. Bounds past mn search like mn (then clip).
    i32 = torch.int32
    nvalid = torch.searchsorted(
        ks, torch.full((B, 1), mn, dtype=i32, device=dev), out_int32=True)
    bounds = torch.clamp(torch.arange(parts + 1, dtype=torch.int64,
                                      device=dev) * part_elems, max=mn)
    bounds = bounds.to(i32).expand(B, -1).contiguous()
    edges = torch.minimum(torch.searchsorted(ks, bounds, out_int32=True),
                          nvalid)
    lo, hi = edges[:, :-1], edges[:, 1:]
    empty = hi <= lo
    first_chunk = lo // chunk
    last_chunk = torch.where(empty, 0, torch.clamp(hi - 1, min=0) // chunk)
    prev_chunk = torch.where(lo > 0, (lo - 1) // chunk, 0)
    nsteps = torch.where(empty, 1, last_chunk - first_chunk + 1)
    off = torch.cat([torch.zeros((B, 1), dtype=i32, device=dev),
                     torch.cumsum(nsteps, -1, dtype=i32)], dim=-1)
    t = torch.arange(max_steps, dtype=i32, device=dev).expand(B, -1)
    t = t.contiguous()
    # part of step t: last offset <= t; t >= total yields `parts` (padding)
    p_of = torch.searchsorted(off, t, right=True, out_int32=True) - 1
    p_clip = torch.clamp(p_of, 0, parts - 1).long()
    j = t - torch.gather(off, 1, p_clip)
    c_of = torch.where(torch.gather(empty, 1, p_clip),
                       torch.gather(prev_chunk, 1, p_clip),
                       torch.gather(first_chunk, 1, p_clip) + j)
    last_real = torch.where(empty[:, -1], prev_chunk[:, -1],
                            last_chunk[:, -1]).unsqueeze(1)
    pad = p_of >= parts
    chunk_id = torch.where(pad, last_real, c_of).to(i32)
    part_id = torch.where(pad, parts, p_of).to(i32)
    if squeeze:
        chunk_id, part_id = chunk_id[0], part_id[0]
    return PartitionSteps(chunk_id=chunk_id, part_id=part_id)


def plan_and_partition(keys: torch.Tensor, shape: Tuple[int, int], *,
                       part_elems: int, chunk: int
                       ) -> Tuple[CompressPlan, torch.Tensor, PartitionSteps]:
    """ONE stable sort shared by the canonical plan and the stream partition.

    Parts are key-aligned (``part = key // part_elems``), so sorting by key
    both yields the canonical ``compress_plan`` layout and groups the
    stream by part with keys sorted inside each part. Returns
    ``(plan, keys_sorted_padded, steps)``; works on ``(cap,)`` or
    ``(B, cap)`` keys.
    """
    m, n = shape
    cap = keys.shape[-1]
    plan = compress_plan(keys, shape)
    cap_pad = ((max(cap, 1) + chunk - 1) // chunk) * chunk
    keys_p = torch.full(keys.shape[:-1] + (cap_pad,), sentinel_key(shape),
                        dtype=torch.int32, device=keys.device)
    keys_p[..., :cap] = torch.gather(keys, -1, plan.order)
    parts = (m * n + part_elems - 1) // part_elems
    steps = partition_steps(keys_p, mn=m * n, part_elems=part_elems,
                            parts=max(parts, 1), chunk=chunk)
    return plan, keys_p, steps


def compress(a: PaddedCOO) -> PaddedCOO:
    """Combine duplicate keys (sort + ordered segment fold). Output is
    key-sorted; the capacity stays ``a.cap`` and ``nnz`` becomes the exact
    count of distinct keys."""
    plan = compress_plan(a.keys, a.shape)
    v_s = torch.gather(a.vals, -1, plan.order)
    # padding sorts last and inherits the last group's id in the plan; the
    # fold drops it instead (id cap), which leaves that group's bits as they
    # are (see segment_fold) and slots past nnz at the fold's +0.0
    slot = torch.arange(a.cap, device=a.keys.device)
    n_valid = a.valid_mask().sum(-1, keepdim=True)
    out_vals = segment_fold(v_s, torch.where(slot < n_valid, plan.gid, a.cap),
                            a.cap)
    return PaddedCOO(keys=plan.out_keys, vals=out_vals, nnz=plan.nnz,
                     shape=a.shape)


def concat(mats, total_cap: int | None = None) -> PaddedCOO:
    """Concatenate k PaddedCOOs of identical logical shape (no dedup)."""
    shape = mats[0].shape
    for a in mats:
        if a.shape != shape:
            raise ValueError("SpKAdd inputs must share a logical shape")
    keys = torch.cat([a.keys for a in mats], dim=-1)
    vals = torch.cat([a.vals for a in mats], dim=-1)
    nnz = functools.reduce(lambda x, y: x + y, [a.nnz for a in mats])
    out = PaddedCOO(keys=keys, vals=vals, nnz=nnz, shape=shape)
    if total_cap is not None and total_cap != out.cap:
        out = with_capacity(out, total_cap)
    return out


def with_capacity(a: PaddedCOO, cap: int) -> PaddedCOO:
    """Grow (pad) or shrink (sorted-truncate) to a new capacity."""
    if cap == a.cap:
        return a
    if cap > a.cap:
        lead = a.keys.shape[:-1] + (cap - a.cap,)
        return PaddedCOO(
            keys=torch.cat([a.keys, torch.full(lead, sentinel_key(a.shape),
                                               dtype=torch.int32,
                                               device=a.keys.device)], -1),
            vals=torch.cat([a.vals, torch.zeros(lead, dtype=a.vals.dtype,
                                                device=a.vals.device)], -1),
            nnz=a.nnz,
            shape=a.shape,
        )
    s = sort_by_key(a)  # valid keys first
    return PaddedCOO(keys=s.keys[..., :cap], vals=s.vals[..., :cap],
                     nnz=torch.clamp(a.nnz, max=cap), shape=a.shape)


def allclose(a: PaddedCOO, b: PaddedCOO, rtol=1e-5, atol=1e-6) -> bool:
    """Dense-equality check used by tests (host-side convenience)."""
    return bool(np.allclose(a.to_dense().cpu().numpy(),
                            b.to_dense().cpu().numpy(), rtol=rtol, atol=atol))
