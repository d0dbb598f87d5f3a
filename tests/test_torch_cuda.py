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
from repro_torch.kernels import hash_slide, ops as kops
from repro_torch.kernels import partition, segment
from repro_torch.kernels.hash_accum import hash_table_size

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def bits(t):
    t = t.detach().cpu()
    return t.view(torch.int32).numpy() if t.dtype == torch.float32 \
        else t.numpy()


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


@pytest.mark.parametrize("rows,length,segs", [(1, 1000, 1000), (3, 257, 40),
                                              (2, 64, 1)])
def test_segment_fold_kernel_bitwise_vs_plain(cuda, rows, length, segs):
    rng = np.random.default_rng(rows * length)
    gid = np.sort(rng.integers(-1, segs + 1, size=(rows, length)), axis=1)
    vals = rng.standard_normal((rows, length)).astype(np.float32)
    vals[:, ::7] = -0.0
    g = torch.as_tensor(gid.astype(np.int32))
    v = torch.as_tensor(vals)
    want = segment.segment_fold(v, g, segs)
    got = segment.segment_fold(v.to(cuda), g.to(cuda), segs)
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
