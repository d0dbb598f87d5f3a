"""The host side of the partition and block top-k kernels' designs, on the CPU.

The CUDA kernels run only on the card (``tests/test_torch_cuda.py``). Here
the host helpers they rely on are held against the kernels' plain versions
and the JAX reference:

- partition: :func:`partition.sub_tile_geometry`; the search rule the
  kernel's ``block_lower_bounds`` follows (``__syncthreads_count``
  narrowing, at 256 and at 3 threads so that it takes many rounds) equals
  ``searchsorted``; and each part's chunk span from ``partition_steps``
  holds every sub-tile's keys, as the kernel's search assumes;
- top-k: :func:`topk_block.order_key` (a stable descending sort of it is
  ``topk_block_plain``, and the reference's Pallas kernel in interpret
  mode agrees), :func:`topk_block.radix_passes` and
  :func:`topk_block.smem_bytes`.

Inputs are made with numpy from a seed. Tolerance everywhere: bitwise.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.topk_block import topk_block_raw as J_topk_block_raw
from repro_torch.core import sparse as TS
from repro_torch.kernels import ops as T_ops
from repro_torch.kernels import partition as T_part
from repro_torch.kernels import topk_block as T_topk

from _torch_parity import assert_bytes_equal, np_of


# ---------------------------------------------------------------------------
# partition: sub-tiles, the block-wide search, and the parts' chunk spans
# ---------------------------------------------------------------------------

def block_lower_bound(row, lo, hi, target, threads=256):
    """The search rule of the kernel's ``block_lower_bounds``: each round
    every thread tests one sample ``lo + t * step`` and the count of
    samples below ``target`` narrows ``[lo, hi]``."""
    while lo < hi:
        step = -(-(hi - lo) // threads)
        pos = lo + np.arange(threads, dtype=np.int64) * step
        pos = pos[pos < hi]
        c = int(np.count_nonzero(row[pos] < target))
        next_hi = lo + c * step
        if c > 0:
            lo += (c - 1) * step + 1
        hi = min(hi, next_hi)
    return lo


def sorted_keys(seed, rows, mn, cap, chunk, dup=1):
    """``rows`` sorted, sentinel-padded key streams (B, cap_pad) of unequal
    lengths."""
    rng = np.random.default_rng(seed)
    cap_pad = -(-cap // chunk) * chunk
    keys = np.full((rows, cap_pad), mn, np.int32)
    for b in range(rows):
        n = cap - 7 * b
        k = rng.integers(0, max(mn // dup, 1), size=n) * dup
        k[rng.random(n) < 0.1] = mn
        keys[b, :n] = np.sort(k)
    return keys


@pytest.mark.parametrize("part_elems,target,want", [
    (54016, 6144, (6016, 9)),    # the vec phase's part at the H100 budget
    (128, 6144, (128, 1)),
    (6144, 6144, (6144, 1)),
    (6145, 6144, (3104, 2)),
    (1000, 96, (96, 11)),
    (100, 1, (32, 4)),
])
def test_sub_tile_geometry(monkeypatch, part_elems, target, want):
    monkeypatch.setattr(T_part, "SUB_TILE_TARGET", target)
    sub_elems, subs = T_part.sub_tile_geometry(part_elems)
    assert (sub_elems, subs) == want
    assert sub_elems % T_part.SUB_TILE_MULT == 0
    assert (subs - 1) * sub_elems < part_elems <= subs * sub_elems


def test_sub_tile_geometry_refuses_empty_parts():
    with pytest.raises(ValueError, match="positive"):
        T_part.sub_tile_geometry(0)


@pytest.mark.parametrize("threads", [256, 3])
@pytest.mark.parametrize("seed", range(4))
def test_block_lower_bound_is_searchsorted(threads, seed):
    rng = np.random.default_rng(seed)
    row = np.sort(rng.integers(0, 50, size=int(rng.integers(1, 3000))))
    for target in (-1, 0, 7, 25, 49, 50, 51):
        for lo, hi in ((0, len(row)), (len(row) // 3, len(row))):
            want = lo + int(np.searchsorted(row[lo:hi], target, "left"))
            assert block_lower_bound(row, lo, hi, target, threads) == want


@pytest.mark.parametrize("mn,cap,part_elems,chunk,dup,target", [
    (512, 300, 128, 32, 1, 32),     # sub-tile edges between runs
    (512, 300, 256, 16, 8, 64),     # duplicates, edges at part edges
    (300, 64, 128, 8, 50, 32),      # runs of 50 over many chunks
    (4096, 100, 256, 16, 1, 96),    # many empty parts and sub-tiles
    (1000, 900, 384, 64, 3, 160),   # ragged last part and sub-tile
])
def test_part_chunk_span_holds_every_sub_tile(monkeypatch, mn, cap,
                                              part_elems, chunk, dup, target):
    """Each part's steps in ``partition_steps``' tables give a chunk span
    ``[chunk_id[t_lo] * chunk, (chunk_id[t_hi - 1] + 1) * chunk)`` that
    holds the keys of each of its sub-tiles (``sub_tile_geometry``), and
    the search within the span finds them."""
    keys = sorted_keys(mn + cap, 3, mn, cap, chunk, dup)
    parts = -(-mn // part_elems)
    steps = TS.partition_steps(torch.as_tensor(keys), mn=mn,
                               part_elems=part_elems, parts=parts,
                               chunk=chunk)
    cid, pid = steps.chunk_id.numpy(), steps.part_id.numpy()
    monkeypatch.setattr(T_part, "SUB_TILE_TARGET", target)
    sub_elems, subs = T_part.sub_tile_geometry(part_elems)
    for b in range(keys.shape[0]):
        for p in range(parts):
            t_lo, t_hi = np.searchsorted(pid[b], [p, p + 1])
            assert t_lo < t_hi  # an empty part still has a step
            span_lo = int(cid[b, t_lo]) * chunk
            span_hi = min((int(cid[b, t_hi - 1]) + 1) * chunk,
                          keys.shape[1])
            for s in range(subs):
                start = p * part_elems + s * sub_elems
                klo = min(start, mn)
                khi = min(start + sub_elems, (p + 1) * part_elems, mn)
                if klo >= khi:
                    continue
                lo, hi = np.searchsorted(keys[b], [klo, khi])
                assert (lo == hi
                        or (span_lo <= lo and hi <= span_hi)), (b, p, s)
                assert block_lower_bound(keys[b], span_lo, span_hi, klo,
                                         3) == np.clip(lo, span_lo, span_hi)


# ---------------------------------------------------------------------------
# block top-k: the order key, its radix passes and its shared memory
# ---------------------------------------------------------------------------

NAN_BITS = np.array([0x7fc00000, 0x7fc00001, 0xffc00000, 0x7f800001],
                    np.uint32)


def topk_input(seed, n, kind):
    rng = np.random.default_rng(seed)
    if kind == "normal":
        x = rng.standard_normal(n).astype(np.float32)
    elif kind == "equal":
        x = rng.choice([-1.5, 1.5], n).astype(np.float32)
    elif kind == "grid":
        x = (rng.integers(-256, 256, n) * 2.0 ** -10).astype(np.float32)
    elif kind == "zeros":
        x = np.where(rng.random(n) < 0.5, 0.0, -0.0).astype(np.float32)
    elif kind == "denormal":
        x = (rng.integers(-4, 5, n) * np.float32(1e-45)).astype(np.float32)
    else:  # "special": NaN payloads and signs, +-inf, +-0 and grid values
        x = (rng.integers(-4, 4, n) * 0.25).astype(np.float32)
        where = rng.choice(n, min(n, 24), replace=False)
        bits = x.view(np.uint32)
        bits[where[:8]] = NAN_BITS[np.arange(8) % 4]
        x[where[8:12]] = [np.inf, -np.inf, np.inf, -np.inf][:len(where[8:12])]
        x[where[12:16]] = -0.0
    return x


@pytest.mark.parametrize("block", [128, 1000, 4096])
@pytest.mark.parametrize("kind", ["normal", "equal", "grid", "zeros",
                                  "denormal", "special"])
def test_order_key_sort_is_the_plain_version(block, kind):
    x = topk_input(block, 3 * block, kind)
    keys = T_topk.order_key(torch.as_tensor(x)).view(3, block)
    order = torch.sort(keys, dim=1, descending=True, stable=True).indices
    want_i, want_v = T_topk.topk_block_plain(torch.as_tensor(x), k=block,
                                             block=block)
    got = (order + torch.arange(3).unsqueeze(1) * block).reshape(-1)
    np.testing.assert_array_equal(np_of(got).astype(np.int32), np_of(want_i))


def test_order_key_values():
    x = np.array([0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, 1e-45, -1e-45],
                 np.float32)
    x = np.concatenate([x, NAN_BITS.view(np.float32)])
    got = np_of(T_topk.order_key(torch.as_tensor(x)))
    assert list(got[:8]) == [0, 0, 0x3f800000, 0x3f800000, 0x7f800000,
                             0x7f800000, 1, 1]
    assert (got[8:] == 0xFFFFFFFF).all()


@pytest.mark.parametrize("kind", ["special", "grid", "zeros"])
def test_order_key_sort_matches_reference_kernel(kind):
    x = topk_input(3, 128, kind)
    gi, gv = J_topk_block_raw(jnp.asarray(x), k=20, block=64)
    keys = T_topk.order_key(torch.as_tensor(x)).view(2, 64)
    order = torch.sort(keys, dim=1, descending=True, stable=True).indices
    got = (order[:, :20] + torch.tensor([[0], [64]])).reshape(-1)
    np.testing.assert_array_equal(np.asarray(gi), np_of(got))
    pi, pv = T_topk.topk_block_raw(torch.as_tensor(x), k=20, block=64)
    assert_bytes_equal(gv, pv)


def test_radix_passes_exit_rule():
    # every |x| distinct in the top byte: the first pass settles k = 1
    x = torch.tensor([1.0, 2.0 ** 20, 3.0, 2.0 ** -20])
    assert T_topk.radix_passes(x, k=1, block=4).tolist() == [1]
    # equal values never settle before the last pass
    assert T_topk.radix_passes(torch.ones(8), k=3, block=8).tolist() == [4]
    # k == block settles once the k-th bucket holds the smallest key's ties
    assert T_topk.radix_passes(torch.ones(8), k=8, block=8).tolist() == [1]
    assert T_topk.radix_passes(torch.ones(8), k=0, block=8).tolist() == [0]


@pytest.mark.parametrize("block,k,want", [
    (4096, 40, 4 * (4096 + 64)),
    (4096, 4096, 4 * (4096 + 4096)),
    (1000, 1, 4 * (1000 + 1)),
    (128, 0, 4 * (128 + 1)),
])
def test_smem_bytes(block, k, want):
    assert T_topk.smem_bytes(block, k) == want


def test_ops_topk_block_unchanged_by_the_kernel_helpers():
    """``ops.topk_block`` on the CPU still equals a stable descending sort
    of the order key over the zero-padded blocks."""
    x = torch.as_tensor(topk_input(4, 1000, "special"))
    idx, val = T_ops.topk_block(x, k=5, block=256)
    xp = torch.zeros(1024)
    xp[:1000] = x
    keys = T_topk.order_key(xp).view(4, 256)
    order = torch.sort(keys, dim=1, descending=True, stable=True).indices
    want = (order[:, :5] + torch.arange(4).unsqueeze(1) * 256).reshape(-1)
    np.testing.assert_array_equal(np_of(idx), np_of(want).astype(np.int32))
    assert np_of(val).tobytes() == np_of(xp[want]).tobytes()
