"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: every test skips where ``torch.cuda.is_available()`` is
false (decided inside the fixture, never at import). On a machine with a
card run ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``. Imports no
JAX: the plain versions are held against the reference package by the CPU
tests (``tests/test_torch_kernels.py``, ``tests/test_torch_engine.py``);
here the kernels are held against the plain versions, bitwise, on the edge
cases those tests cover, and the engine's CUDA results against its CPU
results.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import engine as E
from repro_torch.core import sparse as S
from repro_torch.core import spkadd as A
from repro_torch.kernels import hash_accum, hash_slide, ops as kops
from repro_torch.core import topk as T
from repro_torch.kernels import partition, segment, spa_accum, topk_block
from repro_torch.kernels import xla_add
from repro_torch.kernels.hash_accum import hash_table_size
from repro_torch.runtime import delta_sync as D

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def bits(t):
    t = t.detach().cpu()
    if t.dtype == torch.float32:
        return t.view(torch.int32).numpy()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def sorted_stream(seed, mn, cap, chunk, dup=1):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, max(mn // dup, 1), size=cap) * dup
    keys[rng.random(cap) < 0.1] = mn  # sentinels mid-stream before sorting
    vals = rng.standard_normal(cap).astype(np.float32)
    vals[keys >= mn] = 0.0
    order = np.argsort(keys, kind="stable")
    cap_pad = -(-cap // chunk) * chunk
    kp = np.full(cap_pad, mn, np.int32)
    vp = np.zeros(cap_pad, np.float32)
    kp[:cap], vp[:cap] = keys[order], vals[order]
    return kp, vp


@pytest.mark.parametrize("mn,cap,part_elems,chunk,dup", [
    (512, 300, 128, 32, 1),      # multi-part, boundary-spanning runs
    (512, 300, 512, 64, 8),      # single part, duplicate-heavy
    (4096, 100, 256, 16, 1),     # many empty parts
    (300, 64, 128, 8, 50),       # long runs over many chunks
    (256, 128, 128, 1024, 1),    # one chunk wider than the block
])
def test_partition_kernel_bitwise_vs_plain(cuda, mn, cap, part_elems, chunk,
                                           dup):
    rows = [sorted_stream(seed, mn, cap, chunk, dup) for seed in (1, 2)]
    parts = -(-mn // part_elems)
    keys = torch.as_tensor(np.stack([kp for kp, _ in rows]))
    vals = torch.as_tensor(np.stack([vp for _, vp in rows]))
    steps = S.partition_steps(keys, mn=mn, part_elems=part_elems,
                              parts=parts, chunk=chunk)
    kw = dict(mn=mn, part_elems=part_elems, parts=parts, chunk=chunk)
    want = partition.partitioned_accumulate_raw(keys, vals, *steps, **kw)
    before = partition.partitioned_accumulate_raw.launches
    got = partition.partitioned_accumulate_raw(
        keys.to(cuda), vals.to(cuda), steps.chunk_id.to(cuda),
        steps.part_id.to(cuda), **kw)
    torch.cuda.synchronize()
    assert partition.partitioned_accumulate_raw.launches == before + 1
    np.testing.assert_array_equal(bits(got), bits(want))


def test_partition_kernel_all_sentinel(cuda):
    mn, chunk, part_elems = 256, 32, 128
    keys = torch.full((1, 64), mn, dtype=torch.int32)
    vals = torch.zeros((1, 64))
    steps = S.partition_steps(keys, mn=mn, part_elems=part_elems, parts=2,
                              chunk=chunk)
    got = partition.partitioned_accumulate_raw(
        keys.to(cuda), vals.to(cuda), steps.chunk_id.to(cuda),
        steps.part_id.to(cuda), mn=mn, part_elems=part_elems, parts=2,
        chunk=chunk)
    assert bits(got).tobytes() == np.zeros((1, 256), np.float32).tobytes()


def unequal_rows(seed, rows, mn, cap, chunk, dup=1, neg_zero=False):
    """``rows`` sorted, sentinel-padded streams of unequal lengths."""
    rng = np.random.default_rng(seed)
    cap_pad = -(-cap // chunk) * chunk
    keys = np.full((rows, cap_pad), mn, np.int32)
    vals = np.zeros((rows, cap_pad), np.float32)
    for b in range(rows):
        n = cap - 11 * b
        k = rng.integers(0, max(mn // dup, 1), size=n) * dup
        k[rng.random(n) < 0.1] = mn
        v = rng.standard_normal(n).astype(np.float32)
        if neg_zero:
            v[rng.random(n) < 0.3] = -0.0
        v[k >= mn] = 0.0
        o = np.argsort(k, kind="stable")
        keys[b, :n], vals[b, :n] = k[o], v[o]
    return torch.as_tensor(keys), torch.as_tensor(vals)


def partition_on_card(cuda, keys, vals, *, mn, part_elems, chunk):
    parts = -(-mn // part_elems)
    steps = S.partition_steps(keys, mn=mn, part_elems=part_elems,
                              parts=parts, chunk=chunk)
    kw = dict(mn=mn, part_elems=part_elems, parts=parts, chunk=chunk)
    want = partition.partitioned_accumulate_plain(keys, vals, *steps, **kw)
    before = partition.partitioned_accumulate_raw.launches
    got = partition.partitioned_accumulate_raw(
        keys.to(cuda), vals.to(cuda), steps.chunk_id.to(cuda),
        steps.part_id.to(cuda), **kw)
    torch.cuda.synchronize()
    assert partition.partitioned_accumulate_raw.launches == before + 1
    return got, want


@pytest.mark.parametrize("mn,cap,part_elems,chunk,dup,target,neg_zero", [
    (512, 300, 128, 32, 1, 32, False),    # sub-tile edges between runs
    (512, 300, 256, 16, 8, 64, True),     # edges at part edges, -0.0 runs
    (300, 64, 128, 8, 50, 32, False),     # runs of 50 over many chunks
    (4096, 100, 256, 16, 1, 96, False),   # parts with some sub-tiles empty
    (1000, 900, 384, 64, 3, 160, True),   # ragged last part and sub-tile
    (8192, 6000, 2048, 256, 2, 1, False),  # the smallest sub-tiles, 32
    (8192, 6000, 2048, 256, 1, None, True),  # the default cut
])
def test_partition_sub_tiles_bitwise_vs_plain(cuda, monkeypatch, mn, cap,
                                              part_elems, chunk, dup, target,
                                              neg_zero):
    if target is not None:
        monkeypatch.setattr(partition, "SUB_TILE_TARGET", target)
    keys, vals = unequal_rows(mn + cap, 3, mn, cap, chunk, dup, neg_zero)
    got, want = partition_on_card(cuda, keys, vals, mn=mn,
                                  part_elems=part_elems, chunk=chunk)
    np.testing.assert_array_equal(bits(got), bits(want))


@pytest.mark.parametrize("target", [32, 64])
def test_partition_signed_zero_runs(cuda, monkeypatch, target):
    """A run whose first value is -0.0 and a run summing to -0.0 both fold
    from +0.0 to +0.0; a lone -0.0 too."""
    monkeypatch.setattr(partition, "SUB_TILE_TARGET", target)
    keys = torch.tensor([[3, 3, 5, 9, 9, 9, 40, 41, 41, 128, 128, 128]],
                        dtype=torch.int32)
    vals = torch.tensor([[-0.0, 1.5, -0.0, -0.0, -0.0, -0.0, 2.0, -0.0, -2.5,
                          0, 0, 0]])
    got, want = partition_on_card(cuda, keys, vals, mn=128, part_elems=64,
                                  chunk=4)
    np.testing.assert_array_equal(bits(got), bits(want))
    assert bits(got)[0, [5, 9]].tolist() == [0, 0]


def test_partition_all_sentinel_rows(cuda, monkeypatch):
    monkeypatch.setattr(partition, "SUB_TILE_TARGET", 64)
    keys, vals = unequal_rows(3, 3, 1024, 200, 32)
    keys[1] = 1024
    vals[1] = 0.0
    got, want = partition_on_card(cuda, keys, vals, mn=1024, part_elems=256,
                                  chunk=32)
    np.testing.assert_array_equal(bits(got), bits(want))
    assert not bits(got)[1].any()


def test_partition_vec_geometry_at_reduced_m(cuda):
    """The vec phase's launch (part_elems at the card's budget, the default
    sub-tiles) on a collection cut from 65,536 to 4,096 rows."""
    k, m, n, d = 16, 4096, 512, 64
    mats = _collection(5, k, m, n, n * d, "cpu")
    cat = S.concat(mats)
    geom = kops.partitioned_launch_geometry(
        cat.cap, m=m, n=n, smem_budget_bytes=kops.device_smem_budget(cuda))
    assert geom.part_elems == 54016
    plan, keys_p, steps = S.plan_and_partition(
        cat.keys[None], cat.shape, part_elems=geom.part_elems,
        chunk=geom.chunk)
    vals_p = torch.zeros(keys_p.shape)
    vals_p[:, :cat.cap] = torch.gather(cat.vals[None], -1, plan.order)
    kw = dict(mn=m * n, part_elems=geom.part_elems, parts=geom.parts,
              chunk=geom.chunk)
    want = partition.partitioned_accumulate_plain(keys_p, vals_p, *steps,
                                                  **kw)
    got = partition.partitioned_accumulate_raw(
        keys_p.to(cuda), vals_p.to(cuda), steps.chunk_id.to(cuda),
        steps.part_id.to(cuda), **kw)
    np.testing.assert_array_equal(bits(got), bits(want))
    assert partition.blocks_per_sm(partition.sub_tile_geometry(
        geom.part_elems)[0], cuda) >= 3


@pytest.mark.parametrize("parts,chunk", [(1, 64), (2, 64), (4, 32)])
def test_hash_slide_kernel_bitwise_vs_plain(cuda, parts, chunk):
    mn, cap = 256, 128
    rng = np.random.default_rng(7 + parts)
    keys = rng.integers(0, mn, size=(2, cap)).astype(np.int32)
    vals = rng.standard_normal((2, cap)).astype(np.float32)
    keys[:, ::5] = mn
    vals[:, ::5] = 0.0
    part_span = -(-mn // parts)
    kw = dict(mn=mn, table_size=hash_table_size(min(cap, part_span)),
              part_span=part_span, parts=parts, chunk=chunk)
    wk, wv = hash_slide.hash_slide_raw(torch.as_tensor(keys),
                                       torch.as_tensor(vals), **kw)
    gk, gv = hash_slide.hash_slide_raw(torch.as_tensor(keys).to(cuda),
                                       torch.as_tensor(vals).to(cuda), **kw)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(bits(gk), bits(wk))
    np.testing.assert_array_equal(bits(gv), bits(wv))


def test_hash_slide_kernel_collision_chain(cuda):
    mn, table_size = 1 << 12, 128
    chain = [5 + i * table_size for i in range(6)]
    stream = chain + chain[::-1] + chain
    keys = np.asarray([stream + [mn] * (64 - len(stream))], np.int32)
    vals = np.asarray([np.arange(64, dtype=np.float32) + 1.0])
    vals[keys >= mn] = 0.0
    kw = dict(mn=mn, table_size=table_size, part_span=mn, parts=1, chunk=64)
    wk, wv = hash_slide.hash_slide_raw(torch.as_tensor(keys),
                                       torch.as_tensor(vals), **kw)
    gk, gv = hash_slide.hash_slide_raw(torch.as_tensor(keys).to(cuda),
                                       torch.as_tensor(vals).to(cuda), **kw)
    np.testing.assert_array_equal(bits(gk), bits(wk))
    np.testing.assert_array_equal(bits(gv), bits(wv))


# Edge cases of the ordered segment fold, by name. ``tile`` is the
# kernel's tile (``segment.TILE``: strips of 8 elements a lane, slices of
# 256 a warp inside it); the CPU tests build the same cases at a smaller
# tile against ``jax.ops.segment_sum``.
_RUN_LENGTHS = ("1", "7", "8", "9", "31", "32", "33", "tile-1", "tile",
                "tile+1", "3*tile+5")
_RUN_OFFSETS = ("0", "255", "256", "tile-1")
SEGMENT_FOLD_CASES = (
    [f"random:{r}:{n}:{s}" for r, n, s in ((1, 1000, 1000), (3, 257, 40),
                                           (2, 64, 1))]
    + [f"runs:{n}:{o}" for n in _RUN_LENGTHS for o in _RUN_OFFSETS]
    + ["one-run", "all-dropped", "negative-start", "segs1", "ragged",
       "neg-zero", "subnormal", "bf16-ties", "bf16-nan"])


def _runs_row(rng, lengths, length):
    """Ids of a row of ``length``: runs of the given lengths in turn (the
    last one cycling), ids rising by 1-3 so some segments stay empty."""
    out, gid, i = [], 0, 0
    while len(out) < length:
        n = lengths[min(i, len(lengths) - 1)]
        out.extend([gid] * n)
        gid += int(rng.integers(1, 4))
        i += 1
    return np.asarray(out[:length], np.int64)


def segment_fold_case(case, tile):
    """``(vals, gid, num_segments, bf16)`` of one named case: ``gid`` int32
    ``(B, L)``, non-decreasing along each row; ``vals`` f32, or bf16 as
    their uint16 bits when ``bf16``. Values span many magnitudes, so a
    fold in any other order shows in the bits."""
    name, *arg = case.split(":")
    rng = np.random.default_rng(sum(map(ord, case)))

    def size(expr):
        return int(eval(expr, {"tile": tile}))  # the case table's own terms

    def normal(shape):
        return (rng.standard_normal(shape)
                * 10.0 ** rng.integers(-3, 6, size=shape)).astype(np.float32)

    bf16 = False
    if name == "random":
        rows, length, segs = map(int, arg)
        gid = np.sort(rng.integers(-1, segs + 1, size=(rows, length)), axis=1)
        vals = rng.standard_normal((rows, length)).astype(np.float32)
        vals[:, ::7] = -0.0
    elif name == "runs":
        # row b: off + 3b runs of 1, then runs of n; rows of odd length,
        # so row 1 starts off the 8-element boundaries
        n, off = size(arg[0]), size(arg[1])
        length = off + 3 * n + 2 * tile + 5
        gid = np.stack([_runs_row(rng, [1] * (off + 3 * b) + [n], length)
                        for b in range(2)])
        segs = int(gid.max()) + 3
        vals = normal(gid.shape)
    elif name == "one-run":
        gid = np.repeat(np.arange(2)[:, None], 3 * tile + 5, axis=1)
        segs, vals = 2, normal(gid.shape)
    elif name == "all-dropped":
        segs = 5
        gid = np.stack([np.full(3000, segs), np.full(3000, -1)])
        vals = normal(gid.shape)
    elif name == "negative-start":
        length = 3 * tile + 301
        gid = np.stack([np.concatenate([np.sort(rng.integers(-3, 0, lead)),
                                        _runs_row(rng, [2, 9, 1, 40],
                                                  length - lead)])
                        for lead in (300, tile + 1)])
        segs, vals = int(gid.max()) + 1, normal(gid.shape)
    elif name == "segs1":
        row = np.concatenate([np.full(100, -1), np.zeros(tile + 77, int),
                              np.ones(400, int)])
        gid, segs, vals = row[None], 1, normal((1, row.size))
    elif name == "ragged":
        cap, segs = 2 * tile + 300, 600
        gid = np.full((5, cap), segs)
        for b, nnz in enumerate((0, 1, tile - 1, tile + 1, cap)):
            gid[b, :nnz] = np.sort(rng.integers(0, segs, nnz))
        vals = normal(gid.shape)
        vals[gid == segs] = 0.0
    elif name == "neg-zero":
        gid = _runs_row(rng, [1, 3, 8, 33, 300], 3 * tile)[None]
        segs = int(gid.max()) + 1
        vals = rng.choice(np.float32([-0.0, 0.0, -0.0, 1.5, -2.25]),
                          gid.shape).astype(np.float32)
    elif name == "subnormal":
        gid = _runs_row(rng, [1, 2, 9, 33, 260], 3 * tile)[None]
        segs = int(gid.max()) + 1
        vals = subnormal_vals(rng, gid.shape)
    elif name in ("bf16-ties", "bf16-nan"):
        # ties: 1.0 + 2^-8 is half a bf16 ulp, rounded to even after every
        # add; nan: NaNs of both signs and payloads, infinities of both
        pool = ([0x3F80, 0x3B80, 0x3B80, 0x3C00, 0xBB80, 0x3F81]
                if name == "bf16-ties" else
                [0x7FC0, 0xFFC0, 0xFFC1, 0x7F80, 0xFF80, 0x3F80, 0x4000,
                 0x3F80, 0x4000])
        gid = np.stack([_runs_row(rng, [1, 5, 8, 40, 300], 2 * tile + 9)
                        for _ in range(2)])
        segs, bf16 = int(gid.max()) + 1, True
        vals = rng.choice(np.uint16(pool), gid.shape).astype(np.uint16)
    else:
        raise ValueError(case)
    return vals, gid.astype(np.int32), segs, bf16


def fold_inputs(vals, gid, bf16):
    v = torch.from_numpy(vals.view(np.int16)).view(torch.bfloat16) \
        if bf16 else torch.from_numpy(vals)
    return v, torch.from_numpy(gid)


@pytest.mark.parametrize("case", SEGMENT_FOLD_CASES)
def test_segment_fold_kernel_bitwise_vs_plain(cuda, case):
    """The kernel against the plain fold run on the card (the card's own
    NaN rules apply to both), at the kernel's tile: runs that start and
    end on strip, warp-slice and tile boundaries, runs longer than a tile,
    dropped ids, ragged rows, -0.0, subnormals under -ftz, bf16 ties and
    NaNs."""
    vals, gid, segs, bf16 = segment_fold_case(case, segment.TILE)
    v, g = fold_inputs(vals, gid, bf16)
    v, g = v.to(cuda), g.to(cuda)
    want = segment.segment_fold_plain(v, g, segs)
    before = segment.segment_fold.launches
    got = segment.segment_fold(v, g, segs)
    torch.cuda.synchronize()
    assert segment.segment_fold.launches == before + 1
    np.testing.assert_array_equal(bits(got), bits(want))


@pytest.mark.parametrize("case", ["unaligned", "many-rows"])
def test_segment_fold_kernel_grid_edges_bitwise_vs_plain(cuda, case):
    """Inputs one element into their storage (no 16-byte loads anywhere,
    a run streamed past its tile included), and more rows than the grid
    has (the blocks stride over rows)."""
    rng = np.random.default_rng(41)
    if case == "unaligned":
        gid = np.concatenate([[0], _runs_row(rng, [3, 1, 3 * segment.TILE + 5,
                                                   9, 40], 5 * segment.TILE)])
        v = torch.as_tensor(rng.standard_normal(gid.size).astype(np.float32))
        g = torch.as_tensor(gid.astype(np.int32))
        v, g = v.to(cuda)[1:], g.to(cuda)[1:]
        assert v.data_ptr() % 16 and g.data_ptr() % 16
    else:
        gid = np.sort(rng.integers(-1, 12, size=(70000, 9)), axis=1)
        v = torch.as_tensor(rng.standard_normal(gid.shape).astype(
            np.float32)).to(cuda)
        g = torch.as_tensor(gid.astype(np.int32)).to(cuda)
    segs = int(g.max()) + 1
    want = segment.segment_fold_plain(v, g, segs)
    got = segment.segment_fold(v, g, segs)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(bits(got), bits(want))


def _collection(seed, k, m, n, nnz, device):
    rng = np.random.default_rng(seed)
    mats = []
    for _ in range(k):
        rows = rng.integers(0, m, size=nnz)
        cols = rng.integers(0, n, size=nnz)
        vals = rng.standard_normal(nnz).astype(np.float32)
        mats.append(S.from_coords(rows, cols, vals, (m, n), device=device))
    return mats


@pytest.mark.parametrize("regime", ["tree", "sorted", "spa", "vec",
                                    "blocked_spa", "hash"])
def test_engine_regimes_on_card_equal_cpu(cuda, regime):
    k = 3 if regime == "tree" else 8
    cpu = _collection(5, k, 48, 8, 36, "cpu")
    gpu = [S.PaddedCOO(a.keys.to(cuda), a.vals.to(cuda), a.nnz.to(cuda),
                       a.shape) for a in cpu]
    want = E._CANONICAL["sorted"](cpu)
    got = E._CANONICAL[regime](gpu)
    assert int(got.nnz) == int(want.nnz)
    np.testing.assert_array_equal(bits(got.keys), bits(want.keys))
    np.testing.assert_array_equal(bits(got.vals), bits(want.vals))


@pytest.mark.parametrize("budget", [2048, 8192])
def test_engine_multi_part_on_card_equal_cpu(cuda, budget):
    cpu = _collection(9, 8, 64, 16, 60, "cpu")
    gpu = [S.PaddedCOO(a.keys.to(cuda), a.vals.to(cuda), a.nnz.to(cuda),
                       a.shape) for a in cpu]
    want = E._CANONICAL["sorted"](cpu)
    for got in (E._run_partitioned(gpu, "vec", smem_budget_bytes=budget),
                E._run_hash(gpu, smem_budget_bytes=budget)):
        np.testing.assert_array_equal(bits(got.keys), bits(want.keys))
        np.testing.assert_array_equal(bits(got.vals), bits(want.vals))


def test_device_budget_is_the_block_limit(cuda):
    budget = kops.device_smem_budget(cuda)
    assert 48 * 1024 < budget <= 232448


def test_kernels_refuse_tiles_over_the_block_limit(cuda):
    keys = torch.full((1, 64), 1 << 20, dtype=torch.int32, device=cuda)
    vals = torch.zeros((1, 64), device=cuda)
    steps = S.partition_steps(keys, mn=1 << 20, part_elems=1 << 18, parts=4,
                              chunk=64)
    with pytest.raises(ValueError, match="block limit"):
        partition.partitioned_accumulate_raw(
            keys, vals, *steps, mn=1 << 20, part_elems=1 << 18, parts=4,
            chunk=64)
    with pytest.raises(ValueError, match="block limit"):
        hash_slide.hash_slide_raw(keys, vals, mn=1 << 20, table_size=1 << 16,
                                  part_span=1 << 20, parts=1, chunk=64)


def test_launches_keep_the_callers_current_device(cuda):
    """A launch on the last card makes that card current only for itself;
    the calling thread keeps the device it had (card 0 here)."""
    last = torch.device("cuda", torch.cuda.device_count() - 1)
    cpu = _collection(11, 8, 48, 8, 36, "cpu")
    gpu = [S.PaddedCOO(a.keys.to(last), a.vals.to(last), a.nnz.to(last),
                       a.shape) for a in cpu]
    want = E._CANONICAL["sorted"](cpu)
    with torch.cuda.device(0):
        for regime in ("vec", "hash", "sorted"):
            got = E._CANONICAL[regime](gpu)
            assert torch.cuda.current_device() == 0, regime
            np.testing.assert_array_equal(bits(got.vals), bits(want.vals))


# ---------------------------------------------------------------------------
# spa_accum: the bucketed dense SPA kernels
# ---------------------------------------------------------------------------

def spa_stream(seed, m, n, cap, chunk, *, dup=1, sort=False, sentinel_run=0):
    """A stream of ``cap`` keys (every ``dup``-th key only, so duplicates
    are frequent), 10 % sentinels and, optionally, ``sentinel_run``
    sentinels in a row at the front; padded to a chunk multiple."""
    rng = np.random.default_rng(seed)
    mn = m * n
    keys = rng.integers(0, max(mn // dup, 1), size=cap) * dup
    keys[rng.random(cap) < 0.1] = mn
    keys[:sentinel_run] = mn
    vals = rng.standard_normal(cap).astype(np.float32)
    vals[::9] = -0.0
    vals[keys >= mn] = 0.0
    if sort:
        order = np.argsort(keys, kind="stable")
        keys, vals = keys[order], vals[order]
    cap_pad = -(-cap // chunk) * chunk
    kp = np.full(cap_pad, mn, np.int32)
    vp = np.zeros(cap_pad, np.float32)
    kp[:cap], vp[:cap] = keys, vals
    return torch.as_tensor(kp), torch.as_tensor(vp)


@pytest.mark.parametrize("m,n,cap,block_rows,chunk,dup,sort,sentinel_run", [
    (64, 16, 5000, 16, 1024, 1, False, 0),   # unsorted, duplicates, 4 parts
    (64, 16, 5000, 16, 1024, 37, True, 0),   # sorted runs across steps
    (60, 7, 3000, 16, 64, 5, False, 2048),   # m % block_rows != 0, all-
                                             # sentinel steps first
    (8, 4, 4096, 8, 1024, 8, True, 0),       # one part, runs of ~1,000
    (300, 3, 777, 104, 7, 1, False, 0),      # part edges, odd chunk
])
def test_spa_kernel_bitwise_vs_plain(cuda, m, n, cap, block_rows, chunk, dup,
                                     sort, sentinel_run):
    keys, vals = spa_stream(m * n + cap, m, n, cap, chunk, dup=dup,
                            sort=sort, sentinel_run=sentinel_run)
    kw = dict(m=m, n=n, block_rows=block_rows, chunk=chunk)
    want = spa_accum.spa_accumulate_raw(keys, vals, **kw)
    before = spa_accum.spa_accumulate_raw.launches
    got = spa_accum.spa_accumulate_raw(keys.to(cuda), vals.to(cuda), **kw)
    torch.cuda.synchronize()
    assert spa_accum.spa_accumulate_raw.launches == before + 1
    np.testing.assert_array_equal(bits(got), bits(want))


def test_spa_kernel_keys_at_part_edges(cuda):
    """Every row at and next to a part boundary, in every column, twice."""
    m, n, block_rows = 40, 5, 8
    rows = np.asarray([r for p in range(0, m, block_rows)
                       for r in (p - 1, p, p + block_rows - 1) if 0 <= r < m])
    keys = np.concatenate([(np.arange(n)[:, None] * m + rows).ravel()] * 2)
    vals = np.arange(keys.size, dtype=np.float32) * 0.25 - 3.0
    kp, vp = torch.as_tensor(keys.astype(np.int32)), torch.as_tensor(vals)
    kw = dict(m=m, n=n, block_rows=block_rows, chunk=keys.size)
    want = spa_accum.spa_accumulate_raw(kp, vp, **kw)
    got = spa_accum.spa_accumulate_raw(kp.to(cuda), vp.to(cuda), **kw)
    np.testing.assert_array_equal(bits(got), bits(want))


def test_spa_kernel_refuses_a_too_wide_tile(cuda):
    keys = torch.full((64,), 8 * 8000, dtype=torch.int32, device=cuda)
    vals = torch.zeros(64, device=cuda)
    before = spa_accum.spa_accumulate_raw.launches
    with pytest.raises(ValueError, match="block limit"):
        spa_accum.spa_accumulate_raw(keys, vals, m=8, n=8000, block_rows=8,
                                     chunk=64)
    with pytest.raises(ValueError, match="block limit"):
        kops.spa_accumulate(keys, vals, m=8, n=8000)
    assert spa_accum.spa_accumulate_raw.launches == before


def test_spa_tile_budget_leaves_room_for_the_stage(cuda):
    budget = kops.spa_tile_budget(cuda)
    limit = kops.spa_tile_limit(cuda)
    assert budget == min(kops.SPA_TILE_BYTES, limit)
    assert budget + spa_accum.stage_bytes() <= kops.device_smem_budget(cuda)
    assert limit + spa_accum.stage_bytes() == kops.device_smem_budget(cuda)
    for b in (budget, limit):
        rows = kops.choose_block_rows(65536, 512, b)
        assert rows * 512 * 4 + spa_accum.stage_bytes() <= \
            kops.device_smem_budget(cuda)


@pytest.mark.parametrize("m,n,cap,block_rows,dup,sort,sentinel_run", [
    (64, 16, 5000, 16, 1, False, 0),        # 4 parts, unsorted
    (64, 16, 5000, 16, 37, True, 0),        # sorted runs
    (60, 7, 3000, 16, 5, False, 2048),      # m % block_rows != 0
    (300, 3, 777, 104, 1, False, 0),        # 3 parts
    (4096, 64, 70_000, 8, 3, False, 100),   # 512 parts, 5 subtiles
    (4096, 64, 70_000, 64, 3, True, 100),   # 64 parts: one radix pass
    (480_000, 1, 5000, 8, 1, False, 0),     # 60,000 parts: two passes
    (560_000, 1, 3000, 8, 1, False, 0),     # 70,000 parts: three passes
])
def test_spa_bucket_kernels_bitwise_vs_plain(cuda, m, n, cap, block_rows, dup,
                                             sort, sentinel_run):
    """The count, offsets and scatter kernels give the plain bucketing's
    arrays bit for bit: the same elements in the same order."""
    keys, vals = spa_stream(m * n + cap + 1, m, n, cap, 1, dup=dup,
                            sort=sort, sentinel_run=sentinel_run)
    kw = dict(m=m, n=n, block_rows=block_rows)
    want = spa_accum.spa_bucket_plain(keys, vals, **kw)
    before = spa_accum.spa_bucket_raw.launches
    got = spa_accum.spa_bucket_raw(keys.to(cuda), vals.to(cuda), **kw)
    torch.cuda.synchronize()
    assert spa_accum.spa_bucket_raw.launches == before + 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(bits(g), bits(w))


def test_spa_kernel_empty_parts_and_one_element(cuda):
    """Parts with no element come out as zero tiles; a one-element stream
    and a stream of sentinels only fold as the plain version does."""
    m, n, block_rows = 48, 5, 8
    rows = np.r_[0:8, 24:32]            # parts 1, 2, 4 and 5 stay empty
    rng = np.random.default_rng(4)
    keys = (rng.integers(0, n, 600) * m + rng.choice(rows, 600)).astype(
        np.int32)
    vals = rng.standard_normal(600).astype(np.float32)
    cases = [(keys, vals), (keys[:1], vals[:1]),
             (np.full(64, m * n, np.int32), np.zeros(64, np.float32))]
    for k, v in cases:
        kp, vp = torch.as_tensor(k), torch.as_tensor(v)
        kw = dict(m=m, n=n, block_rows=block_rows, chunk=k.size)
        want = spa_accum.spa_accumulate_plain(kp, vp, **kw)
        got = spa_accum.spa_accumulate_raw(kp.to(cuda), vp.to(cuda), **kw)
        np.testing.assert_array_equal(bits(got), bits(want))
    assert (got == 0).all()


def test_spa_kernel_across_tile_sizes(cuda):
    """The result does not depend on block_rows: every tile size from the
    smallest to the block limit gives the plain version's bits."""
    m, n = 2048, 96
    keys, vals = spa_stream(5, m, n, 40_000, 1024, dup=2)
    kw = dict(m=m, n=n, chunk=1024)
    want = spa_accum.spa_accumulate_plain(keys, vals, block_rows=8, **kw)
    limit_rows = kops.choose_block_rows(m, n, kops.spa_tile_limit(cuda))
    for rows in (8, 16, 80, limit_rows):
        got = spa_accum.spa_accumulate_raw(keys.to(cuda), vals.to(cuda),
                                           block_rows=rows, **kw)
        np.testing.assert_array_equal(bits(got), bits(want))


# ---------------------------------------------------------------------------
# hash_accum: the faithful single-table hash kernels
# ---------------------------------------------------------------------------

def hash_stream(seed, cap, key_range, sent):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, key_range, size=cap).astype(np.int32)
    keys[rng.random(cap) < 0.1] = sent
    vals = rng.standard_normal(cap).astype(np.float32)
    vals[::7] = -0.0
    return torch.as_tensor(keys), torch.as_tensor(vals)


@pytest.mark.parametrize("cap,key_range,table_size", [
    (4096, 6000, None),       # 16,384 slots: shared-memory table
    (16384, 30000, None),     # 65,536 slots: device-memory table
    (3000, 500, None),        # duplicate-heavy, shared memory
    (300, 200, 64),           # undersized: probes wrap and overwrite
    (5000, 100000, 65536),    # explicit large table, device memory
])
def test_hash_kernels_bitwise_vs_plain(cuda, cap, key_range, table_size):
    sent = 1 << 20
    keys, vals = hash_stream(cap + key_range, cap, key_range, sent)
    kw = dict(sent=sent, table_size=table_size)
    wk, wv = hash_accum.hash_accumulate_plain(keys, vals, **kw)
    before = hash_accum.hash_accumulate_raw.launches
    gk, gv = hash_accum.hash_accumulate_raw(keys.to(cuda), vals.to(cuda),
                                            **kw)
    torch.cuda.synchronize()
    assert hash_accum.hash_accumulate_raw.launches == before + 1
    np.testing.assert_array_equal(bits(gk), bits(wk))
    np.testing.assert_array_equal(bits(gv), bits(wv))
    want = hash_accum.hash_symbolic_plain(keys, **kw)
    got = hash_accum.hash_symbolic_raw(keys.to(cuda), **kw)
    assert got.device.type == "cuda" and int(got) == int(want)


def test_hash_kernels_collision_chain_and_empty(cuda):
    table_size, sent = 128, 4096
    chain = [5 + i * table_size for i in range(6)]
    stream = chain + chain[::-1] + chain
    keys = torch.as_tensor(np.asarray(stream + [sent] * 46, np.int32))
    vals = torch.arange(64, dtype=torch.float32) + 1.0
    for k, v in ((keys, vals), (keys[:0], vals[:0]),
                 (torch.full((16,), sent, dtype=torch.int32), vals[:16])):
        wk, wv = hash_accum.hash_accumulate_plain(k, v, sent=sent,
                                                  table_size=table_size)
        gk, gv = hash_accum.hash_accumulate_raw(k.to(cuda), v.to(cuda),
                                                sent=sent,
                                                table_size=table_size)
        np.testing.assert_array_equal(bits(gk), bits(wk))
        np.testing.assert_array_equal(bits(gv), bits(wv))
        assert int(hash_accum.hash_symbolic_raw(k.to(cuda), sent=sent)) == \
            int(hash_accum.hash_symbolic_plain(k, sent=sent))


def chain_keys(table_size, sent, length=64):
    chain = [5 + i * table_size for i in range(6)]
    stream = chain + chain[::-1] + chain
    return np.asarray(stream + [sent] * (length - len(stream)), np.int32)


@pytest.mark.parametrize("case,route", [
    ("random_smem", "smem"),          # 4,096 keys: 16,384 slots in smem
    ("random_device", "device"),      # 16,384 keys: 65,536 slots in HBM
    ("minus_one_smem", "smem"),       # each -1 counts, its slot stays free
    ("minus_one_device", "device"),
    ("chain_smem", "smem"),           # collision chain, default table
    ("chain_device", "device"),       # the chain in an explicit big table
    ("empty_smem", "smem"),
    ("empty_device", "device"),
    ("undersized", "serial"),         # table <= cap: the one-thread loop
    ("undersized_minus_one", "serial"),
])
def test_hash_symbolic_routes_bitwise_vs_plain(cuda, case, route):
    rng = np.random.default_rng(len(case))
    sent, table_size = 1 << 20, None
    if case.startswith("random") or case.startswith("minus_one"):
        cap = 4096 if case.endswith("smem") else 16384
        keys = rng.integers(0, 3 * cap, size=cap).astype(np.int32)
        keys[rng.random(cap) < 0.1] = sent
        if case.startswith("minus_one"):
            keys[rng.random(cap) < 0.05] = -1
    elif case.startswith("chain"):
        keys = chain_keys(128, sent)
        table_size = None if case.endswith("smem") else 1 << 16
    elif case.startswith("empty"):
        keys = np.zeros(0, np.int32)
        table_size = None if case.endswith("smem") else 1 << 16
    else:
        keys = rng.permutation(np.repeat(np.arange(300) * 7, 2)).astype(
            np.int32)
        table_size = 256
        if case.endswith("minus_one"):
            keys[rng.choice(keys.size, 40, replace=False)] = -1
    kt = torch.as_tensor(keys)
    size = (hash_table_size(len(keys) + 1) if table_size is None
            else table_size)
    assert hash_accum.symbolic_route(len(keys), size, device=cuda) == route
    want = hash_accum.hash_symbolic_plain(kt, sent=sent,
                                          table_size=table_size)
    launches = hash_accum.hash_symbolic_raw.launches
    serial = hash_accum.hash_symbolic_raw.serial_launches
    got = hash_accum.hash_symbolic_raw(kt.to(cuda), sent=sent,
                                       table_size=table_size)
    torch.cuda.synchronize()
    assert got.device.type == "cuda" and got.dtype == torch.int32
    assert int(got) == int(want)
    assert hash_accum.hash_symbolic_raw.launches == launches + 1
    assert hash_accum.hash_symbolic_raw.serial_launches == \
        serial + (route == "serial")


def slide_stream(case, seed):
    """``(keys, vals, kwargs)`` of a sliding-hash launch for ``case``."""
    rng = np.random.default_rng(seed)
    B, cap, chunk = 3, 512, 64
    if case == "parts_over_256":      # 300 parts: two bucketing passes
        span, parts = 8, 300
        mn = span * parts
    elif case == "empty_parts":       # keys in 2 of 16 parts; a row empty
        span, parts, mn = 16, 16, 256
    elif case == "one_key":
        span, parts, mn = 1024, 1, 1024
    else:                              # "minus_one": negative keys skipped
        span, parts, mn = 64, 8, 512
    keys = rng.integers(0, mn, (B, cap))
    if case == "empty_parts":
        keys = rng.choice([3, 7, 9, 200, 201], (B, cap))
        keys[1] = mn
    elif case == "one_key":
        keys[:] = 77
    elif case == "minus_one":
        keys[rng.random((B, cap)) < 0.2] = -1
    keys[rng.random((B, cap)) < 0.05] = mn
    vals = rng.standard_normal((B, cap)).astype(np.float32)
    kw = dict(mn=mn, table_size=hash_table_size(min(cap, span)),
              part_span=span, parts=parts, chunk=chunk)
    return torch.as_tensor(keys.astype(np.int32)), torch.as_tensor(vals), kw


@pytest.mark.parametrize("case", ["parts_over_256", "empty_parts", "one_key",
                                  "minus_one"])
def test_hash_slide_kernel_edges_bitwise_twice(cuda, case):
    """B > 1 and parts > 1 (up to 300: the bucketing's two passes), empty
    parts, one key, negative keys; two launches give the same bits, so no
    atomic decides a value."""
    keys, vals, kw = slide_stream(case, len(case))
    wk, wv = hash_slide.hash_slide_plain(keys, vals, **kw)
    runs = [hash_slide.hash_slide_raw(keys.to(cuda), vals.to(cuda), **kw)
            for _ in range(2)]
    torch.cuda.synchronize()
    for gk, gv in runs:
        np.testing.assert_array_equal(bits(gk), bits(wk))
        np.testing.assert_array_equal(bits(gv), bits(wv))


@pytest.mark.parametrize("case,route", [
    ("minus_one", "parallel"),       # -1 keys fold where the loop adds them
    ("minus_one_first", "parallel"),  # a -1 before the key that takes its slot
    ("one_key", "parallel"),
    ("random_big", "parallel"),      # 2^18 keys: 2^19 slots, 128 ranges
    ("undersized", "serial"),        # table <= cap: the one-thread loop
    ("undersized_minus_one", "serial"),
])
def test_hash_accumulate_routes_bitwise_twice(cuda, case, route):
    rng = np.random.default_rng(len(case) + 3)
    sent, table_size = 1 << 20, None
    if case.startswith("minus_one"):
        keys = rng.integers(-1, 40, 3000)
        if case == "minus_one_first":
            T = hash_table_size(301)  # the default table of the 300 below
            h = ((0xFFFFFFFF * 2654435761) & (T - 1))
            k = next(k for k in range(1, 1 << 20)
                     if (k * 2654435761) & (T - 1) == h)
            keys = np.asarray([-1, -1, k, -1, k, -1] * 50)
    elif case == "one_key":
        keys = np.full(5000, 123)
    elif case == "random_big":
        keys = rng.integers(0, 1 << 19, 1 << 18)
    else:
        keys = rng.permutation(np.repeat(np.arange(300) * 7, 2))
        table_size = 256
        if case.endswith("minus_one"):
            keys[rng.choice(keys.size, 40, replace=False)] = -1
    keys = keys.astype(np.int32)
    keys[rng.random(keys.size) < 0.05] = sent
    vals = torch.as_tensor(rng.standard_normal(keys.size).astype(np.float32))
    kt = torch.as_tensor(keys)
    size = (hash_table_size(len(keys) + 1) if table_size is None
            else table_size)
    assert hash_accum.accumulate_route(len(keys), size) == route
    wk, wv = hash_accum.hash_accumulate_plain(kt, vals, sent=sent,
                                              table_size=table_size)
    launches = hash_accum.hash_accumulate_raw.launches
    serial = hash_accum.hash_accumulate_raw.serial_launches
    runs = [hash_accum.hash_accumulate_raw(kt.to(cuda), vals.to(cuda),
                                           sent=sent, table_size=table_size)
            for _ in range(2)]
    torch.cuda.synchronize()
    for gk, gv in runs:
        np.testing.assert_array_equal(bits(gk), bits(wk))
        np.testing.assert_array_equal(bits(gv), bits(wv))
    assert hash_accum.hash_accumulate_raw.launches == launches + 2
    assert hash_accum.hash_accumulate_raw.serial_launches == \
        serial + 2 * (route == "serial")


def subnormal_vals(rng, shape):
    """Values mixing normals, subnormals of both signs and pairs whose sum
    is subnormal: the -ftz builds must flush as the plain versions do."""
    return rng.choice(np.float32([1e-40, -1e-40, 1.5e-38, -1.4e-38, -0.0,
                                  2.0, -3e-39]), shape).astype(np.float32)


@pytest.mark.parametrize("kernel", ["segment_fold", "partition", "spa_accum",
                                    "hash_slide", "hash_accum"])
def test_ftz_kernels_flush_subnormals_as_the_plain_versions(cuda, kernel):
    rng = np.random.default_rng(31)
    mn, cap = 64, 1024
    keys = np.sort(rng.integers(0, mn, cap)).astype(np.int32)
    vals = subnormal_vals(rng, cap)
    k, v = torch.as_tensor(keys), torch.as_tensor(vals)
    if kernel == "segment_fold":
        want = segment.segment_fold(v, k, mn)
        got = segment.segment_fold(v.to(cuda), k.to(cuda), mn)
        pairs = [(got, want)]
    elif kernel == "partition":
        kw = dict(mn=mn, part_elems=16, parts=4, chunk=64)
        steps = S.partition_steps(k[None], mn=mn, part_elems=16, parts=4,
                                  chunk=64)
        want = partition.partitioned_accumulate_plain(k[None], v[None],
                                                      *steps, **kw)
        got = partition.partitioned_accumulate_raw(
            k[None].to(cuda), v[None].to(cuda), steps.chunk_id.to(cuda),
            steps.part_id.to(cuda), **kw)
        pairs = [(got, want)]
    elif kernel == "spa_accum":
        kw = dict(m=mn, n=1, block_rows=16, chunk=64)
        perm = torch.as_tensor(rng.permutation(cap))
        want = spa_accum.spa_accumulate_plain(k[perm], v[perm], **kw)
        got = spa_accum.spa_accumulate_raw(k[perm].to(cuda),
                                           v[perm].to(cuda), **kw)
        pairs = [(got, want)]
    elif kernel == "hash_slide":
        perm = torch.as_tensor(rng.permutation(cap))
        kw = dict(mn=mn, table_size=128, part_span=mn, parts=1, chunk=64)
        wk, wv = hash_slide.hash_slide_plain(k[perm][None], v[perm][None],
                                             **kw)
        gk, gv = hash_slide.hash_slide_raw(k[perm][None].to(cuda),
                                           v[perm][None].to(cuda), **kw)
        pairs = [(gk, wk), (gv, wv)]
    else:
        perm = torch.as_tensor(rng.permutation(cap))
        wk, wv = hash_accum.hash_accumulate_plain(k[perm], v[perm], sent=mn)
        gk, gv = hash_accum.hash_accumulate_raw(k[perm].to(cuda),
                                                v[perm].to(cuda), sent=mn)
        pairs = [(gk, wk), (gv, wv)]
    torch.cuda.synchronize()
    for got, want in pairs:
        np.testing.assert_array_equal(bits(got), bits(want))


def test_bf16_segment_fold_kernel_nan_signs(cuda):
    """bf16 folds round a NaN total to the quiet NaN of its sign, on the
    card as in the plain version there: -NaN + 1.0, +inf + -inf,
    1.0 + -NaN."""
    raw = np.asarray([0xFFC0, 0x3F80, 0x7F80, 0xFF80, 0x3F80, 0xFFC1,
                      0x4000], np.uint16)
    vals = torch.from_numpy(raw.view(np.int16)).view(torch.bfloat16)
    gid = torch.as_tensor(np.int32([0, 0, 1, 1, 2, 2, 3]))
    want = segment.segment_fold_plain(vals.to(cuda), gid.to(cuda), 4)
    got = segment.segment_fold(vals.to(cuda), gid.to(cuda), 4)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(bits(got), bits(want))
    assert torch.isnan(got[:3].float()).all() and float(got[3]) == 2.0


@pytest.mark.parametrize("algorithm", sorted(A.ALGORITHMS))
def test_family_on_card_equals_cpu(cuda, algorithm):
    cpu = _collection(17, 6, 48, 8, 40, "cpu")
    gpu = [S.PaddedCOO(a.keys.to(cuda), a.vals.to(cuda), a.nnz.to(cuda),
                       a.shape) for a in cpu]
    want = A.spkadd(cpu, algorithm=algorithm)
    got = A.spkadd(gpu, algorithm=algorithm)
    assert int(got.nnz) == int(want.nnz)
    np.testing.assert_array_equal(bits(got.keys), bits(want.keys))
    np.testing.assert_array_equal(bits(got.vals), bits(want.vals))


# ---------------------------------------------------------------------------
# the ordered segment fold: bf16 values and long padding runs
# ---------------------------------------------------------------------------

def _bf16_collection(seed, k, m, n, nnz, device):
    return [a._replace(vals=a.vals.to(torch.bfloat16))
            for a in _collection(seed, k, m, n, nnz, device)]


@pytest.mark.parametrize("algorithm", ["incremental", "tree", "sorted",
                                       "spa"])
def test_bf16_family_on_card_equals_cpu(cuda, algorithm):
    """bf16 values through the ordered segment fold: the card's bits are
    the CPU's (each add rounded to bf16, as PyTorch's bf16 add does)."""
    cpu = _bf16_collection(21, 6, 48, 8, 40, "cpu")
    gpu = [S.PaddedCOO(a.keys.to(cuda), a.vals.to(cuda), a.nnz.to(cuda),
                       a.shape) for a in cpu]
    want = A.spkadd(cpu, algorithm=algorithm)
    before = segment.segment_fold.launches
    got = A.spkadd(gpu, algorithm=algorithm)
    torch.cuda.synchronize()
    assert segment.segment_fold.launches > before
    assert got.vals.dtype == torch.bfloat16
    assert int(got.nnz) == int(want.nnz)
    np.testing.assert_array_equal(bits(got.keys), bits(want.keys))
    np.testing.assert_array_equal(bits(got.vals), bits(want.vals))
    np.testing.assert_array_equal(bits(gpu[0].to_dense()),
                                  bits(cpu[0].to_dense()))


def test_bf16_segment_fold_kernel_bitwise_vs_plain(cuda):
    rng = np.random.default_rng(22)
    gid = np.sort(rng.integers(0, 50, size=(2, 3000)), axis=1)
    vals = torch.as_tensor(rng.standard_normal((2, 3000)).astype(np.float32)
                           * 100).to(torch.bfloat16)
    g = torch.as_tensor(gid.astype(np.int32))
    want = segment.segment_fold(vals, g, 50)
    got = segment.segment_fold(vals.to(cuda), g.to(cuda), 50)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(bits(got), bits(want))


def test_long_padding_stream_bitwise_vs_plain(cuda):
    """A capacity far past nnz (the two-way adds' layout): the padding run
    is dropped from the fold, and the result is the CPU's bit for bit, in
    both the old layout (padding carrying the last group's id) and the
    compress path's."""
    rng = np.random.default_rng(23)
    cap, nnz, segs = 1 << 20, 300, 64
    gid = np.full(cap, segs - 1, np.int32)
    gid[:nnz] = np.sort(rng.integers(0, segs, nnz))
    vals = np.zeros(cap, np.float32)
    vals[:nnz] = rng.standard_normal(nnz)
    vals[nnz:][rng.random(cap - nnz) < 0.5] = -0.0
    g, v = torch.as_tensor(gid), torch.as_tensor(vals)
    for gg in (g, torch.where(torch.arange(cap) < nnz, g, segs)):
        want = segment.segment_fold(v, gg, segs)
        got = segment.segment_fold(v.to(cuda), gg.to(cuda), segs)
        np.testing.assert_array_equal(bits(got), bits(want))
    a = S.with_capacity(_collection(24, 1, 512, 64, nnz, "cpu")[0], cap)
    want = S.compress(a)
    got = S.compress(S.PaddedCOO(a.keys.to(cuda), a.vals.to(cuda),
                                 a.nnz.to(cuda), a.shape))
    np.testing.assert_array_equal(bits(got.keys), bits(want.keys))
    np.testing.assert_array_equal(bits(got.vals), bits(want.vals))


# ---------------------------------------------------------------------------
# the block top-k kernel and the delta-sync path
# ---------------------------------------------------------------------------

def _topk_input(seed, n, kind):
    rng = np.random.default_rng(seed)
    if kind == "normal":
        x = rng.standard_normal(n)
    elif kind == "equal":      # every |x| equal: ties all the way
        x = rng.choice([-1.5, 1.5], n)
    elif kind == "zeros":      # +0.0 and -0.0 only
        x = np.where(rng.random(n) < 0.5, 0.0, -0.0)
    else:                      # the delta-sync grid: many ties
        x = rng.integers(-256, 256, n) * 2.0 ** -10
    return torch.as_tensor(x.astype(np.float32))


@pytest.mark.parametrize("block", [128, 4096])
@pytest.mark.parametrize("per", [1, 40, -1])
@pytest.mark.parametrize("kind", ["normal", "equal", "zeros", "grid"])
def test_topk_block_kernel_bitwise_vs_plain(cuda, block, per, kind):
    per = block - 1 if per == -1 else per
    x = _topk_input(block + per, 5 * block, kind)
    wi, wv = topk_block.topk_block_plain(x, k=per, block=block)
    before = topk_block.topk_block_raw.launches
    gi, gv = topk_block.topk_block_raw(x.to(cuda), k=per, block=block)
    torch.cuda.synchronize()
    assert topk_block.topk_block_raw.launches == before + 1
    np.testing.assert_array_equal(bits(gi), bits(wi))
    np.testing.assert_array_equal(bits(gv), bits(wv))


_NAN_BITS = [0x7fc00000, 0x7fc00001, 0xffc00000, 0x7f800001]


def _topk_edge_input(seed, n, kind):
    rng = np.random.default_rng(seed)
    if kind == "denormal":
        x = (rng.integers(-4, 5, n) * np.float32(1e-45)).astype(np.float32)
    elif kind == "signed_zeros":  # +-0 ties beside a few nonzeros
        x = np.where(rng.random(n) < 0.5, 0.0, -0.0).astype(np.float32)
        x[rng.choice(n, 3, replace=False)] = [1.0, -1.0, 2.0 ** -149]
    elif kind == "special":  # NaN payloads and signs, +-inf beside them
        x = (rng.integers(-4, 4, n) * 0.25).astype(np.float32)
        where = rng.choice(n, 16, replace=False)
        x.view(np.uint32)[where[:8]] = np.array(_NAN_BITS * 2, np.uint32)
        x[where[8:12]] = [np.inf, -np.inf, np.inf, -np.inf]
    else:
        return _topk_input(seed, n, kind)
    return torch.as_tensor(x)


@pytest.mark.parametrize("block", [128, 1000, 4096])
@pytest.mark.parametrize("per", [1, 40, -1, 0])
@pytest.mark.parametrize("kind", ["grid", "equal", "special", "denormal",
                                  "signed_zeros"])
def test_topk_block_radix_select_bitwise_vs_plain(cuda, block, per, kind):
    per = {-1: block - 1, 0: block}.get(per, per)
    x = _topk_edge_input(block * 7 + per, 3 * block, kind)
    wi, wv = topk_block.topk_block_plain(x, k=per, block=block)
    gi, gv = topk_block.topk_block_raw(x.to(cuda), k=per, block=block)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(bits(gi), bits(wi))
    np.testing.assert_array_equal(bits(gv), bits(wv))


def test_topk_block_kernel_nan_and_padded_tail(cuda):
    x = _topk_input(30, 4096 + 1000, "grid")
    x[[3, 17, 4200]] = float("nan")
    x[5] = -float("nan")
    want = kops.topk_block(x, k=40, block=4096)  # zero-padded tail block
    got = kops.topk_block(x.to(cuda), k=40, block=4096)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(bits(g), bits(w))


def test_topk_block_refuses_a_block_over_the_budget(cuda):
    block = 1 << 16  # 256 KiB of f32 > one block's shared memory
    before = topk_block.topk_block_raw.launches
    with pytest.raises(ValueError, match="exceeds the kernel's shared"):
        topk_block.topk_block_raw(torch.zeros(block, device=cuda), k=1,
                                  block=block)
    assert topk_block.topk_block_raw.launches == before


def test_empty_inputs_launch_nothing(cuda):
    """A launch counter counts launches: an empty input returns empty
    outputs without one."""
    t0, s0 = topk_block.topk_block_raw.launches, segment.segment_fold.launches
    idx, val = topk_block.topk_block_raw(torch.zeros(0, device=cuda), k=3,
                                         block=64)
    out = segment.segment_fold(torch.zeros(0, device=cuda),
                               torch.zeros(0, dtype=torch.int32,
                                           device=cuda), 5)
    torch.cuda.synchronize()
    assert idx.numel() == val.numel() == 0 and out.shape == (5,)
    assert (out == 0).all()
    assert topk_block.topk_block_raw.launches == t0
    assert segment.segment_fold.launches == s0


@pytest.mark.parametrize("selector", ["global", "block"])
def test_sparsify_with_feedback_on_card_equals_cpu(cuda, selector):
    res_c, res_g = torch.zeros(9000), torch.zeros(9000, device=cuda)
    for step in range(3):
        g = _topk_input(40 + step, 9000, "grid")
        uc, res_c = T.sparsify_with_feedback(g, res_c, 90, selector=selector)
        ug, res_g = T.sparsify_with_feedback(g.to(cuda), res_g, 90,
                                             selector=selector)
        for a, b in ((ug.idx, uc.idx), (ug.val, uc.val), (res_g, res_c)):
            np.testing.assert_array_equal(bits(a), bits(b))


def test_apply_delta_flat_on_card_equals_cpu(cuda):
    rng = np.random.default_rng(41)
    flat = torch.as_tensor(np.where(rng.random(5000) < 0.2, -0.0,
                                    rng.standard_normal(5000))
                           .astype(np.float32))
    idx = torch.as_tensor(np.concatenate([
        rng.choice(5000, 700, replace=False), [5000, 5000, -1]])
        .astype(np.int32))
    val = torch.as_tensor(np.where(rng.random(703) < 0.3, 0.0,
                                   rng.standard_normal(703))
                          .astype(np.float32))
    want = D.apply_delta_flat(flat, idx, val)
    got = D.apply_delta_flat(flat.to(cuda), idx.to(cuda), val.to(cuda))
    np.testing.assert_array_equal(bits(got), bits(want))


def test_delta_sync_on_card_equals_cpu(cuda):
    """Publisher frames byte for byte and the subscriber's window fold
    bitwise, card against CPU, on a tree whose large leaf takes the block
    top-k kernel and the engine's vec regime."""
    rng = np.random.default_rng(42)
    shapes = {"embed": (300, 100), "ln": (3, 40)}

    def grid(lo, hi):
        return {k: torch.as_tensor(rng.integers(lo, hi, s).astype(np.float32)
                                   * 2.0 ** -10) for k, s in shapes.items()}

    params = grid(-512, 512)
    sides = []
    for dev in ("cpu", cuda):
        on = {k: v.to(dev) for k, v in params.items()}
        wire = D.InProcTransport()
        sides.append((D.DeltaPublisher(on, wire, k_fraction=0.05,
                                       selector="block", device=dev),
                      D.DeltaSubscriber(on, wire, device=dev)))
    (pub_c, sub_c), (pub_g, sub_g) = sides
    for epoch in range(1, 5):
        upd = grid(-256, 256)
        params = {k: params[k] + upd[k] for k in params}
        pub_c.publish(params)
        pub_g.publish({k: v.to(cuda) for k, v in params.items()})
        assert pub_g.frames_for(epoch) == pub_c.frames_for(epoch)
    report_c, report_g = sub_c.sync(), sub_g.sync()
    assert tuple(report_g) == tuple(report_c) and report_g.window == 4
    for k in shapes:
        np.testing.assert_array_equal(bits(sub_g.params[k]),
                                      bits(sub_c.params[k]))
        np.testing.assert_array_equal(bits(sub_c.params[k]),
                                      bits(pub_c.shadow_params()[k]))


SUBNORMAL_PAIRS = np.float32([
    [1e-40, 1e-40], [-1e-40, 0.0], [1.5e-38, 1.4e-38], [-1.4e-38, -1.5e-38],
    [-0.0, -1e-40], [2.0, 1e-40], [1.4e-38, -1.5e-38], [-3e-39, 3e-39],
    [np.inf, 1.0], [-0.0, 0.0]])


#: NaNs and infinities of both signs, planted beside the subnormal pairs.
NAN_INF_PAIRS = np.float32([
    [np.nan, 1.0], [-np.nan, -2.0], [np.inf, np.inf], [-np.inf, np.inf],
    [1.0, -np.nan], [np.inf, -1.0], [-np.inf, 1e-40]])
#: One block's span in one trip of the kernel's grid-stride loop: THREADS
#: float4 groups on the vector route (1,024 elements), THREADS elements on
#: the scalar route; the loop's stride at the largest grid.
XLA_ADD_SPAN = xla_add.THREADS
XLA_ADD_STRIDE = xla_add.MAX_BLOCKS * xla_add.THREADS


@pytest.mark.parametrize("n,a_off,b_off", [
    (1, 0, 0), (7, 0, 0), (4099, 0, 0), (4099, 1, 1), (1 << 20, 0, 0),
    (4 * XLA_ADD_SPAN - 1, 0, 0), (4 * XLA_ADD_SPAN, 0, 0),
    (4 * XLA_ADD_SPAN + 1, 0, 0), (8 * XLA_ADD_SPAN + 3, 0, 0),
    (XLA_ADD_SPAN - 1, 1, 1), (XLA_ADD_SPAN, 2, 2), (XLA_ADD_SPAN + 1, 3, 3),
    (4 * XLA_ADD_STRIDE - 1, 0, 0), (4 * XLA_ADD_STRIDE + 5, 0, 0),
    (XLA_ADD_STRIDE + 1, 1, 1), (17280, 0, 0), (576, 0, 0),
    (3317760, 0, 0), (5001, 1, 0), (5001, 0, 2), (5001, 3, 1),
    (17280, 2, 0)])
@pytest.mark.parametrize("edges", [False, True])
@pytest.mark.parametrize("subtract", [False, True])
def test_xla_add_kernel_bitwise_vs_plain(cuda, n, a_off, b_off, edges,
                                         subtract):
    """Subnormal inputs and results flushed to a zero of their sign, on the
    vector route (its float4 groups, a block's span in one trip of the loop
    and the loop's stride at the largest grid, the scalar tail), on the
    scalar route (a view off a 16-byte boundary, ``a`` and ``b`` at
    different offsets), at the publisher's two smallest leaves; with NaNs
    and infinities planted too (``edges``), held to the plain version run
    on the card, whose f32 adds make the same NaN. One launch a call, on
    the route the pointers' alignment names."""
    rng = np.random.default_rng(n * 16 + a_off * 4 + b_off)
    pairs = (np.concatenate([SUBNORMAL_PAIRS, NAN_INF_PAIRS]) if edges
             else SUBNORMAL_PAIRS)
    ab = rng.standard_normal((2, n + 3)).astype(np.float32)
    pick = rng.integers(0, len(pairs), n + 3)
    plant = rng.random(n + 3) < 0.3
    ab[:, plant] = pairs[pick[plant]].T
    a = torch.as_tensor(ab[0])[a_off:a_off + n]
    b = torch.as_tensor(ab[1])[b_off:b_off + n]
    a_dev = torch.as_tensor(ab[0]).to(cuda)[a_off:a_off + n]
    b_dev = torch.as_tensor(ab[1]).to(cuda)[b_off:b_off + n]
    assert (a_dev.data_ptr() % 16 == 0) == (a_off == 0)
    before = xla_add.xla_add_raw.launches
    routes = dict(xla_add.xla_add_raw.routes)
    got = xla_add.xla_add_raw(a_dev, b_dev, subtract=subtract)
    torch.cuda.synchronize()
    assert xla_add.xla_add_raw.launches == before + 1
    route = "vector" if a_off == b_off == 0 else "scalar"
    other = "scalar" if route == "vector" else "vector"
    assert xla_add.xla_add_raw.routes[route] == routes[route] + 1
    assert xla_add.xla_add_raw.routes[other] == routes[other]
    np.testing.assert_array_equal(
        bits(got), bits(xla_add.xla_add_plain(a_dev, b_dev,
                                              subtract=subtract)))
    if not edges:  # no NaN: the CPU's plain version gives the same bits
        np.testing.assert_array_equal(
            bits(got), bits(xla_add.xla_add_plain(a, b, subtract=subtract)))


def test_subnormal_publish_on_card_equals_cpu(cuda):
    """A publish whose deltas are subnormal: frames, residuals and shadow
    on the card equal the CPU's bits (the CPU's are the reference's,
    ``tests/test_torch_faults.py``)."""
    zeros = {"a": torch.zeros(2), "b": torch.zeros(4)}
    moved = {"a": torch.tensor([1e-40, 2.0]),
             "b": torch.tensor([1e-40, 2.0, 0.0, 0.0])}
    sides = []
    for dev in ("cpu", cuda):
        wire = D.InProcTransport()
        pub = D.DeltaPublisher({k: v.to(dev) for k, v in zeros.items()},
                               wire, k_fraction=0.5, device=dev)
        pub.publish({k: v.to(dev) for k, v in moved.items()})
        sides.append((pub, wire.poll()))
    (pub_c, frames_c), (pub_g, frames_g) = sides
    assert frames_g == frames_c
    for a, b in zip(pub_g._residual, pub_c._residual):
        np.testing.assert_array_equal(bits(a), bits(b))
    for k in zeros:
        np.testing.assert_array_equal(bits(pub_g.shadow_params()[k]),
                                      bits(pub_c.shadow_params()[k]))


# ---------------------------------------------------------------------------
# the stream service (core/streaming, core/stream_service)
# ---------------------------------------------------------------------------

def test_truncate_by_magnitude_on_card_equals_cpu(cuda):
    """NaN (both signs), ties of equal magnitude, +-0 and sentinel slots
    picked by a cap past the valid entries, in one batched input."""
    from repro_torch.core.streaming import truncate_by_magnitude

    sent = 64
    rng = np.random.default_rng(51)
    keys = np.stack([rng.permutation(64)[:40] for _ in range(3)])
    keys[:, 30:] = sent
    vals = rng.choice(np.float32([1, -1, 2, -2, 0.5, -0.0, 0.0, np.nan,
                                  -np.nan]), keys.shape)
    vals[keys == sent] = 0.0
    a = S.PaddedCOO(torch.as_tensor(keys.astype(np.int32)),
                    torch.as_tensor(vals), torch.full((3,), 30,
                                                      dtype=torch.int32),
                    (8, 8))
    for cap in (5, 20, 35):
        want = truncate_by_magnitude(a, cap)
        got = truncate_by_magnitude(
            S.PaddedCOO(a.keys.to(cuda), a.vals.to(cuda), a.nnz.to(cuda),
                        a.shape), cap)
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(bits(g), bits(w))


def _service_drive(dev, root):
    """crash_replay's cell at 32 x 8 with capacity 64 (sums truncate):
    crash at flush 3, recovery over the journal, resume, drain."""
    from repro_torch.core.stream_service import StreamService
    from repro_torch.launch import stream_serve as SV
    from repro_torch.runtime.faults import (ServiceFaultInjector,
                                            ServiceFaultSpec)

    names = [SV.tenant_name(i) for i in range(4)]
    events = SV.build_workload(n_tenants=4, duration=4.0, rate=3.0,
                               tick_every=0.25, seed=52)

    def svc(fault_injector=None):
        s = StreamService(flush_deadline=0.5, journal_root=str(root),
                          fault_injector=fault_injector, device=dev)
        replayed = sum(s.register_tenant(n, (32, 8), cap_budget=64,
                                         batch_k=3) for n in names)
        return s, replayed

    def mk(a):
        return SV.make_matrix((32, 8), 16, a.mat_seed, device=dev)

    crash, _ = svc(ServiceFaultInjector(ServiceFaultSpec(
        crash_at_flush=(3,))))
    res = SV.drive(crash, events, make_mat=mk)
    assert not res.completed
    rec, replayed = svc()
    assert replayed > 0
    SV.drive(rec, events, make_mat=mk, start_index=res.next_index)
    rec.drain(4.0)
    return {n: tuple(bits(t) for t in rec.value(n)[:3]) for n in names}, \
        rec.stats()


def test_stream_service_drive_on_card_equals_cpu(cuda, tmp_path):
    before = segment.segment_fold.launches
    want, want_stats = _service_drive("cpu", tmp_path / "cpu")
    got, got_stats = _service_drive(cuda, tmp_path / "cuda")
    torch.cuda.synchronize()
    assert segment.segment_fold.launches > before  # the co-flushes' spa
    assert got_stats == want_stats
    for name in want:
        for g, w in zip(got[name], want[name]):
            np.testing.assert_array_equal(g, w)


def test_coflush_at_full_width_launches_bucketed_hash_slide(cuda):
    """Four tenants of 65,536 x 256 with a 16,384-entry budget and one
    15-push window each: one co-flush, dispatched to ``hash``, whose
    sliding-hash launch buckets each row by part; equal to a ``sorted``
    service's co-flush bitwise."""
    from repro_torch import obs
    from repro_torch.core.stream_service import StreamService
    from repro_torch.launch import stream_serve as SV

    shape, names = (65536, 256), [SV.tenant_name(i) for i in range(4)]
    outs = {}
    for alg in ("auto", "sorted"):
        svc = StreamService(flush_deadline=0.5, algorithm=alg, device=cuda)
        for n in names:
            svc.register_tenant(n, shape, cap_budget=16384, batch_k=15)
        for i, n in enumerate(names):
            for j in range(15):
                svc.push(n, SV.make_matrix(shape, 512, 1000 * i + j,
                                           device=cuda), now=0.01 * j)
        before = hash_slide.hash_slide_raw.launches
        reports = svc.tick(now=1.0)
        torch.cuda.synchronize()
        assert len(reports) == 1 and reports[0].tenants == 4
        launched = hash_slide.hash_slide_raw.launches - before
        if alg == "auto":
            assert launched == 1
            assert obs.gauge("kernels.hash_slide.parts").value > 1
        else:
            assert launched == 0
        outs[alg] = {n: tuple(bits(t) for t in svc.value(n)[:3])
                     for n in names}
    for n in names:
        for g, w in zip(outs["auto"][n], outs["sorted"][n]):
            np.testing.assert_array_equal(g, w)


# -- the sparse gradient allreduce, AdamW and SpGEMM on the card ------------

def _worker_streams(seed, p, size, k, selector):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((p, size)).astype(np.float32)
    pick = T.topk_global if selector == "global" else T.topk_block
    return [pick(torch.from_numpy(g[w]), k) for w in range(p)]


@pytest.mark.parametrize("sched,acc", [("gather_kway", "scatter"),
                                       ("gather_kway", "vec"),
                                       ("tree_2way", "scatter"),
                                       ("ring_2way", "scatter")])
@pytest.mark.parametrize("size,k,selector", [(1000, 50, "global"),
                                             (70000, 3500, "block")])
def test_allreduce_local_folds_on_card_equal_cpu(cuda, sched, acc, size, k,
                                                 selector):
    """Every rank's fold of P = 8 workers' streams (in its
    ``stream_order``), on the card and on the CPU: the same bits."""
    from repro_torch.core import allreduce as AR

    p = 8
    us = _worker_streams(5, p, size, k, selector)
    for rank in (0, 3):
        order = AR.stream_order(sched, p, rank)
        idx = torch.stack([us[w].idx for w in order])
        val = torch.stack([us[w].val for w in order])
        want = AR.local_fold(idx, val, size, acc)
        got = AR.local_fold(idx.to(cuda), val.to(cuda), size, acc)
        assert np.array_equal(bits(got), bits(want)), (sched, acc, rank)


def test_allreduce_scatter_equals_vec_on_card(cuda):
    from repro_torch.core import allreduce as AR

    us = _worker_streams(6, 8, 70000, 3500, "block")
    idx = torch.stack([u.idx for u in us]).to(cuda)
    val = torch.stack([u.val for u in us]).to(cuda)
    before = spa_accum.spa_accumulate_raw.launches
    vec = AR.local_fold(idx, val, 70000, "vec")
    assert spa_accum.spa_accumulate_raw.launches == before + 1
    assert np.array_equal(bits(vec), bits(AR.local_fold(idx, val, 70000)))


def test_adamw_on_card_equals_cpu(cuda):
    """The sums' order (the global norm) and the last bit of pow and sqrt
    differ between the devices: each element within 1e-6 of its leaf's
    largest magnitude, the tolerance of tests/test_torch_optim.py."""
    from repro_torch import tree as TR
    from repro_torch.optim import adamw as OPT

    rng = np.random.default_rng(8)
    shapes = {"w": (256, 384), "b": (384,), "emb": (3, 128, 96)}
    params = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for k, s in shapes.items()}
    grads = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             for k, s in shapes.items()}

    def two_steps(dev):
        p = TR.tree_map(lambda x: x.to(dev), params)
        g = TR.tree_map(lambda x: x.to(dev), grads)
        st = OPT.adamw_init(p)
        for _ in range(2):
            lr = OPT.cosine_schedule(st.step, peak_lr=1e-3, warmup=1,
                                     total=10)
            p, st, gn = OPT.adamw_update(p, g, st, lr=lr)
        return TR.leaves(p) + TR.leaves(st.mu) + TR.leaves(st.nu) + [gn]

    for a, b in zip(two_steps(cuda), two_steps("cpu")):
        scale = float(b.abs().max()) or 1.0
        assert float((a.cpu() - b).abs().max()) <= 1e-6 * scale


@pytest.fixture
def nccl_world(cuda):
    """One NCCL rank (world size 1) with a gloo group of the same rank for
    CPU tensors; destroyed after the test."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield dist.new_group(backend="gloo")
    finally:
        dist.destroy_process_group()


def test_spgemm_summa_on_a_1x1_nccl_mesh(nccl_world):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import spgemm as G
    from repro_torch.launch import spgemm_demo

    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
    a, b = spgemm_demo.sprand_pair(0, 512, 512, 256, 0.05)
    want = G.summa_block(torch.from_numpy(a), torch.from_numpy(b), 1,
                         algorithm="sorted")
    for alg in ("sorted", "vec", "auto"):
        c = G.spgemm_summa(torch.from_numpy(a).cuda(),
                           torch.from_numpy(b).cuda(), mesh, algorithm=alg)
        np.testing.assert_allclose(c.cpu().numpy(), a @ b, rtol=1e-4,
                                   atol=1e-5)
        # one stage: the product's sums are the library's, the reduction
        # the port's; the card's product may differ from the CPU's by an
        # ulp, so the tiles are compared at the reference's tolerance
        np.testing.assert_allclose(c.cpu().numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("sched", ["gather_kway", "tree_2way", "ring_2way"])
def test_compressed_gradient_mean_on_card_equals_cpu(nccl_world, sched):
    """At world size 1 the NCCL group on the card and a gloo group on the
    CPU give the same mean and residuals, bit for bit."""
    from repro_torch.core import allreduce as AR

    rng = np.random.default_rng(9)
    grads = {"w": rng.standard_normal((70, 1000)).astype(np.float32),
             "b": rng.standard_normal((300,)).astype(np.float32)}
    res = {k: (0.1 * rng.standard_normal(v.size)).astype(np.float32)
           for k, v in grads.items()}
    out = {}
    for dev, group in (("cuda", None), ("cpu", nccl_world)):
        g = {k: torch.from_numpy(v).to(dev) for k, v in grads.items()}
        r = {k: torch.from_numpy(v).to(dev) for k, v in res.items()}
        out[dev] = AR.compressed_gradient_mean(g, r, group, 0.05,
                                               schedule=sched)
    for tree_c, tree_h in zip(out["cuda"], out["cpu"]):
        for k in grads:
            assert np.array_equal(bits(tree_c[k]), bits(tree_h[k])), k


# ---------------------------------------------------------------------------
# the dense decoder workload (models, train steps) on the card
# ---------------------------------------------------------------------------

def _model_outputs(arch, dev, compute_dtype="float32"):
    import dataclasses

    from repro_torch import tree as TR
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.models.layers import use_full_precision

    use_full_precision()
    cfg = dataclasses.replace(get_smoke_config(arch),
                              compute_dtype=compute_dtype)
    model = build_model(cfg)
    params = model.init(0, device=dev)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 33),
                                             dtype=np.int32)
    batch = {"tokens": torch.from_numpy(toks[:, :-1].copy()).to(dev),
             "labels": torch.from_numpy(toks[:, 1:].copy()).to(dev)}
    leaves, treedef = TR.flatten(params)
    leaves = [x.requires_grad_() for x in leaves]
    loss = model.loss(TR.unflatten(treedef, leaves), batch, ce_chunk=16,
                      attn_chunk=8)
    grads = torch.autograd.grad(loss, leaves)
    params = TR.unflatten(treedef, [x.detach() for x in leaves])
    logits, caches = model.prefill(params, batch["tokens"], max_len=41,
                                   attn_chunk=8)
    decoded = []
    tok = logits.argmax(-1)
    for _ in range(8):
        logits, caches = model.decode_step(params, caches, tok, attn_chunk=8)
        decoded.append(logits)
        tok = logits.argmax(-1)
    return ([loss.detach()] + list(grads) + decoded), tok


@pytest.mark.parametrize("arch", ["smollm-135m", "internlm2-1.8b",
                                  "stablelm-3b"])
def test_model_on_card_equals_cpu(cuda, arch):
    """Loss, grads and eight decode steps of the f32 smoke configs: the
    card against the CPU at the CPU parity tests' tolerance (each value
    within 1e-5 of its scale, grads 1e-4)."""
    card, card_tok = _model_outputs(arch, cuda)
    cpu, cpu_tok = _model_outputs(arch, "cpu")
    for i, (a, b) in enumerate(zip(card, cpu)):
        scale = float(b.abs().max()) or 1.0
        tol = 1e-4 if 0 < i <= 12 else 1e-5
        assert float((a.cpu() - b).abs().max()) <= tol * scale, i
    assert torch.equal(card_tok.cpu(), cpu_tok)


def test_bf16_model_on_card_equals_cpu(cuda):
    card, _ = _model_outputs("smollm-135m", cuda, "bfloat16")
    cpu, _ = _model_outputs("smollm-135m", "cpu", "bfloat16")
    assert abs(float(card[0]) - float(cpu[0])) <= 2e-3 * float(cpu[0])
    for a, b in zip(card[13:], cpu[13:]):  # decode logits
        assert float((a.cpu() - b).abs().max()) <= 0.1


def test_model_refuses_tf32(cuda):
    from repro_torch.models import layers as L

    q = torch.zeros(1, 2, 2, 8, device=cuda)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            L.blockwise_attention(q, q, q)
    finally:
        L.use_full_precision()
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    try:
        with pytest.raises(RuntimeError, match="reduce in f32"):
            L.blockwise_attention(q, q, q)
    finally:
        L.use_full_precision()


def test_lossless_compressed_step_on_card_tracks_dense(nccl_world):
    """k 1.0 on one NCCL rank: the compressed step tracks the dense step
    on the card within the reference's own bound (rtol 2e-4, atol 2e-5,
    three steps)."""
    from repro_torch import tree as TR
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.models.layers import use_full_precision
    from repro_torch.optim import adamw_init
    from repro_torch.train import (TrainHParams, make_compressed_train_step,
                                   make_train_step, rank_ef_state)

    use_full_precision()
    model = build_model(get_smoke_config("smollm-135m"))
    hp = TrainHParams(ce_chunk=16, attn_chunk=16, remat=False,
                      total_steps=100, warmup=0)
    dense = make_train_step(model, hp)
    comp = make_compressed_train_step(model, None, hp, k_fraction=1.0,
                                      selector="global")
    pd = pc = model.init(0, device="cuda")
    od = oc = adamw_init(pd)
    ef = rank_ef_state(pc)
    rng = np.random.default_rng(5)
    for _ in range(3):
        toks = torch.from_numpy(rng.integers(0, 128, (8, 33),
                                             dtype=np.int32)).cuda()
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        pd, od, md = dense(pd, od, batch)
        pc, oc, ef, mc = comp(pc, oc, ef, batch)
        assert abs(float(md["loss"]) - float(mc["loss"])) < 1e-4
    for a, b in zip(TR.leaves(pd), TR.leaves(pc)):
        torch.testing.assert_close(b, a, rtol=2e-4, atol=2e-5)


def test_sharded_dense_step_is_bitwise_plain_on_one_nccl_rank(nccl_world):
    """The twin of ``chip_smoke.py`` phase ``sharding`` (a) at smoke size:
    on a (1, 1) ``("data", "model")`` NCCL mesh, params and AdamW state
    placed by ``params_shardings``, three dense steps through the DTensor
    path equal three plain steps bitwise (every collective is the identity
    at world 1), and a checkpoint of the sharded state restores onto its
    placements and onto plain tensors bitwise."""
    import tempfile

    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch import tree as TR
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.models.layers import use_full_precision
    from repro_torch.optim import adamw_init
    from repro_torch.sharding.params import (distribute, gathered,
                                             params_shardings)
    from repro_torch.train import TrainHParams, make_train_step

    use_full_precision()
    model = build_model(get_smoke_config("smollm-135m"))
    step = make_train_step(model, TrainHParams(ce_chunk=16, attn_chunk=16,
                                               total_steps=100, warmup=0))
    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
    p = model.init(0, device="cuda")
    o = adamw_init(p)
    sh = params_shardings(p, mesh)
    sp = distribute(p, sh)
    so = adamw_init(sp)
    rng = np.random.default_rng(6)
    for _ in range(3):
        toks = torch.from_numpy(rng.integers(0, 128, (8, 33),
                                             dtype=np.int32)).cuda()
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        p, o, met = step(p, o, batch)
        sp, so, smet = step(sp, so, batch)
        assert np.array_equal(bits(met["loss"]), bits(smet["loss"]))
        assert np.array_equal(bits(met["grad_norm"]),
                              bits(smet["grad_norm"]))
    plain = TR.leaves((p, o.mu, o.nu))
    for a, b in zip(plain, TR.leaves(gathered((sp, so.mu, so.nu)))):
        assert np.array_equal(bits(a), bits(b))
    assert all(isinstance(x, DTensor) for x in TR.leaves(so.mu))
    with tempfile.TemporaryDirectory() as tmp:
        save_checkpoint(tmp, 3, (sp, so.mu, so.nu))
        back = restore_checkpoint(tmp, 3, (sp, so.mu, so.nu),
                                  (sh, sh, sh))
        flat = restore_checkpoint(tmp, 3, (p, o.mu, o.nu))
    for a, b, c in zip(plain, TR.leaves(back), TR.leaves(flat)):
        assert isinstance(b, DTensor) and not isinstance(c, DTensor)
        assert np.array_equal(bits(a), bits(b.full_tensor()))
        assert np.array_equal(bits(a), bits(c))


# ---------------------------------------------------------------------------
# the MoE, gemma3 local:global and VLM decoders, the Mamba2 SSM, the Zamba2
# hybrid and the Whisper encoder-decoder on the card
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ["moonshot-v1-16b-a3b", "llama4-scout-17b-a16e", "gemma3-27b",
                "qwen2-vl-72b", "mamba2-370m", "zamba2-2.7b",
                "whisper-medium"]


def _family_outputs(arch, dev):
    """Loss, grads, prefill and eight decode logits of a family's f32 smoke
    config (the CPU draw of its init, the same numpy batch)."""
    from repro_torch import tree as TR
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.models.layers import use_full_precision

    use_full_precision()
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    params = model.init(0, device=dev)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (2, 33), dtype=np.int32)
    batch = {"labels": torch.from_numpy(toks[:, 1:].copy()).to(dev)}
    if cfg.family == "vlm":
        batch["embeds"] = torch.from_numpy(rng.standard_normal(
            (2, 32, cfg.d_model)).astype(np.float32)).to(dev)
        pos = np.broadcast_to(np.arange(32, dtype=np.int32), (3, 2, 32))
        batch["mrope_positions"] = torch.from_numpy(pos // [[[1]], [[3]],
                                                            [[5]]]).to(dev)
        prompt = {"embeds": batch["embeds"]}
    else:
        batch["tokens"] = torch.from_numpy(toks[:, :-1].copy()).to(dev)
        prompt = {"tokens": batch["tokens"]}
    if cfg.family == "encdec":  # frame embeddings (12, not a chunk multiple)
        batch["embeds"] = prompt["embeds"] = torch.from_numpy(
            rng.standard_normal((2, cfg.n_frames, cfg.d_model)).astype(
                np.float32)).to(dev)
    leaves, treedef = TR.flatten(params)
    leaves = [x.requires_grad_() for x in leaves]
    loss = model.loss(TR.unflatten(treedef, leaves), batch, ce_chunk=16,
                      attn_chunk=8)
    grads = [torch.zeros_like(x) if g is None else g for g, x in zip(
        torch.autograd.grad(loss, leaves, allow_unused=True), leaves)]
    params = TR.unflatten(treedef, [x.detach() for x in leaves])
    logits, caches = model.prefill(params, **prompt, max_len=40,
                                   attn_chunk=8)
    decoded = [logits]
    tok = logits.argmax(-1)
    for _ in range(8):
        logits, caches = model.decode_step(params, caches, tok, attn_chunk=8)
        decoded.append(logits)
        tok = logits.argmax(-1)
    return [loss.detach()], grads, decoded, tok


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_decoder_family_on_card_equals_cpu(cuda, arch):
    """Loss, every gradient, the prefill and eight decode steps (gemma3's
    crossing its ring's wrap; the SSM scan over four chunks; the hybrid's
    shared block at two sites) of the f32 smoke configs: the card against
    the CPU at the CPU parity tests' tolerance (1e-5 of each value's scale,
    grads 1e-4 of a leaf's)."""
    card = _family_outputs(arch, cuda)
    cpu = _family_outputs(arch, "cpu")
    for group, tol in zip(range(3), (1e-5, 1e-4, 1e-5)):
        for i, (a, b) in enumerate(zip(card[group], cpu[group])):
            scale = float(b.abs().max()) or 1.0
            assert float((a.cpu() - b).abs().max()) <= tol * scale, (group, i)
    assert torch.equal(card[3].cpu(), cpu[3])


def _combine_edges(seed, dtype, T=300, K=6, d=96):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((T, K, d)).astype(np.float32)
    c[0, 1] = -c[0, 0]                     # exact cancellation
    c[1] = -0.0
    c[2, :, :8] = np.float32(1e-40)        # subnormals flush
    c[3, :, 8:16] = np.float32(2.0 ** -24)  # ties at rounding
    c[3, 0, 8:16] = 1.0
    c[4:40] = c[4]                         # equal rows: tied contributions
    c[5, :, 3] = 0.5                       # equal within a token
    return torch.from_numpy(c).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seed", [0, 1])
def test_moe_combine_on_card_bitwise_to_plain_fold(cuda, dtype, seed):
    """The MoE combine at K = 6 (the ``moe_combine`` kernel, one launch, no
    segment fold) against the plain left-to-right fold on the card and the
    combine on the CPU, bitwise."""
    from repro_torch.kernels import moe_combine as MC
    from repro_torch.models import moe as MOE

    c = _combine_edges(seed, dtype)
    before = MC.moe_combine_raw.launches, segment.segment_fold.launches
    got = MOE.combine(c.to(cuda))
    torch.cuda.synchronize()
    assert (MC.moe_combine_raw.launches,
            segment.segment_fold.launches) == (before[0] + 1, before[1])
    plain = MOE.combine_plain(c.to(cuda))
    cpu = MOE.combine(c)
    assert np.array_equal(bits(got), bits(plain))
    assert np.array_equal(bits(got), bits(cpu))


#: f32 bit patterns planted in the combine's edge cases (here and in
#: ``tests/test_torch_moe_combine.py``): subnormals and signed zeros,
#: infinities, NaNs of both signs (one with a payload), the least normal.
COMBINE_EDGES = np.array(
    [0x00000001, 0x80000001, 0x007FFFFF, 0x807FFFFF, 0x00000000, 0x80000000,
     0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00000, 0x7FA00001, 0x00800000],
    dtype=np.uint32).view(np.float32)


def combine_planted(seed, dtype, T, K, d):
    """(T, K, d) normals, a seeded tenth set to the edge patterns, a token
    of cancellations and one of ``-0.0``; bf16 by XLA's rounding (a NaN
    keeps its sign)."""
    from repro_torch.kernels import xla_float

    rng = np.random.default_rng(seed)
    c = rng.standard_normal((T, K, d)).astype(np.float32)
    pick = rng.random((T, K, d)) < 0.1
    c[pick] = rng.choice(COMBINE_EDGES, int(pick.sum()))
    if K > 1:
        c[0, 1] = -c[0, 0]
    c[1] = -0.0
    c = torch.from_numpy(c)
    return xla_float.round_bf16(c) if dtype == torch.bfloat16 else c


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "misaligned"])
@pytest.mark.parametrize("d", [7, 96, 2048])
@pytest.mark.parametrize("K", [1, 6, 9])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_combine_kernel_bitwise_to_plain_at_edges(cuda, dtype, K, d,
                                                      offset):
    """The kernel against ``moe_combine_plain`` on the card, bitwise, with
    planted subnormals, signed zeros, infinities and NaNs of both signs: the
    16-byte path, the element path (d = 7, or a view one element off a
    16-byte boundary), K past one group of loads (9); one launch a
    call."""
    from repro_torch.kernels import moe_combine as MC

    T = 700 if d == 2048 else 3000
    c = combine_planted(K * 1000 + d, dtype, T, K, d)
    flat = torch.empty(c.numel() + offset, dtype=dtype, device=cuda)
    flat[offset:] = c.reshape(-1).to(cuda)
    view = flat[offset:].view(T, K, d)
    assert (view.data_ptr() % 16 == 0) == (offset == 0)
    before = MC.moe_combine_raw.launches, segment.segment_fold.launches
    got = MC.moe_combine_raw(view)
    torch.cuda.synchronize()
    assert (MC.moe_combine_raw.launches,
            segment.segment_fold.launches) == (before[0] + 1, before[1])
    want = MC.moe_combine_plain(view)
    assert got.shape == (T, d) and got.dtype == dtype
    assert np.array_equal(bits(got), bits(want))


def test_moe_combine_kernel_refuses_other_types_on_card(cuda):
    from repro_torch.kernels import moe_combine as MC

    with pytest.raises(TypeError, match="moe_combine_raw"):
        MC.moe_combine_raw(torch.zeros(4, 2, 8, dtype=torch.float16,
                                       device=cuda))
    with pytest.raises(ValueError, match="moe_combine_raw"):
        MC.moe_combine_raw(torch.zeros(4, 8, device=cuda))


@pytest.mark.parametrize("arch", ["gemma3-27b", "qwen2-vl-72b",
                                  "mamba2-370m"])
def test_decoder_family_refuses_tf32(cuda, arch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.models import layers as L

    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    params = model.init(0, device=cuda)
    batch = {"labels": torch.zeros((1, 16), dtype=torch.int32, device=cuda)}
    if cfg.family == "vlm":
        batch["embeds"] = torch.zeros((1, 16, cfg.d_model), device=cuda)
        batch["mrope_positions"] = torch.zeros((3, 1, 16), dtype=torch.int32,
                                               device=cuda)
    else:
        batch["tokens"] = torch.zeros((1, 16), dtype=torch.int32, device=cuda)
    q = torch.zeros(1, 16, 2, 8, device=cuda)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            model.loss(params, batch, ce_chunk=8, attn_chunk=8)
        with pytest.raises(RuntimeError, match="TF32"):
            L.local_window_attention(q, q, q, window=4)
    finally:
        L.use_full_precision()


def test_kv_quant_on_card_equals_cpu(cuda):
    """int8 codes and scales of the same keys and values on the card and on
    the CPU, bitwise (f32 and bf16 inputs, a ring write past the end); the
    quantized attention within 1e-5 of the CPU's and 5e-2 of the exact
    attention (``tests/test_extensions.py``'s bound)."""
    from repro_torch.models import layers as L
    from repro_torch.serve import kv_quant as Q

    L.use_full_precision()
    rng = np.random.default_rng(3)
    k, v = (torch.from_numpy(rng.standard_normal((2, 40, 4, 64)).astype(
        np.float32)) for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((2, 1, 8, 64)).astype(
        np.float32))
    kn = torch.from_numpy(rng.standard_normal((2, 1, 4, 64)).astype(
        np.float32))
    for dt in (torch.float32, torch.bfloat16):
        caches = []
        for dev in (cuda, "cpu"):
            c = Q.quantize_kv(k.to(dev, dt), v.to(dev, dt), length=39)
            c = Q.quant_cache_update_decode(c, kn.to(dev, dt),
                                            kn.to(dev, dt))
            c = Q.quant_cache_update_decode(c, kn.to(dev, dt),
                                            -kn.to(dev, dt))
            caches.append(c)
        for a, b in zip(*caches):
            assert torch.equal(a.cpu(), b), dt
    cache = Q.quantize_kv(k.to(cuda), v.to(cuda))
    got = Q.attention_with_quant_cache(q.to(cuda), cache, chunk=16)
    cpu = Q.attention_with_quant_cache(q, Q.quantize_kv(k, v), chunk=16)
    exact = L.blockwise_attention(q, k, v, causal=False, kv_len=40, chunk=16)
    assert float((got.cpu() - cpu).abs().max()) <= 1e-5 * float(
        cpu.abs().max())
    torch.testing.assert_close(got.cpu(), exact, rtol=5e-2, atol=5e-2)
