"""Faults of the port against the reference, each on the smallest input
that showed it (ROADMAP queue 3), held bitwise on the CPU.

A. XLA treats a subnormal f32 input of an add or a compare as a zero of its
   sign and flushes a subnormal result; the port's folds, its ``!= 0``
   tests and its delta scatter-add follow (``kernels/xla_float.py``).
B. XLA rounds a bf16 NaN to the quiet NaN of its sign; the port's bf16
   folds keep the sign.
C. ``interop.padded_coo_from_numpy`` takes a reference PaddedCOO with bf16
   values, bit for bit.
D. ``interop.params_from_numpy`` takes a reference params tree of
   ``jax.Array`` leaves.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import engine as JE
from repro.core import sparse as JS
from repro.core.spkadd import spkadd as ref_spkadd
from repro.kernels import ref as JR
from repro.runtime import delta_sync as JD
from repro_torch import interop
from repro_torch import tree as port_tree
from repro_torch.core import engine as TE
from repro_torch.core import sparse as TS
from repro_torch.core import spkadd as TA
from repro_torch.kernels import hash_accum, hash_slide, partition, segment
from repro_torch.kernels import spa_accum, xla_float
from repro_torch.runtime import delta_sync as TD

from _torch_parity import np_of, to_port

CPU = "cpu"


def bits(x):
    """The raw bits of a tensor or array (bf16 and f32 as integers)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        x = x.numpy()
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return x.view(np.int16)
    return x.view(np.int32) if x.dtype == np.float32 else x


def assert_same_coo(ref, port, msg=""):
    assert tuple(ref.shape) == tuple(port.shape), msg
    np.testing.assert_array_equal(np.asarray(ref.keys), np_of(port.keys),
                                  err_msg=msg)
    np.testing.assert_array_equal(np.asarray(ref.nnz), np_of(port.nnz),
                                  err_msg=msg)
    np.testing.assert_array_equal(bits(ref.vals), bits(port.vals),
                                  err_msg=msg)


def f32(bits):
    return np.asarray(bits, np.uint32).view(np.float32)


def bf16(bits):
    return np.asarray(bits, np.uint16).view(jnp.bfloat16)


# ---------------------------------------------------------------------------
# A. subnormals
# ---------------------------------------------------------------------------

ADD_CASES = [
    (-1e-40, 0.0),        # -> +0.0
    (-1e-40, -0.0),       # -> -0.0
    (1e-40, 1e-40),       # both inputs flushed
    (1.5e-38, -1.4e-38),  # normal inputs, subnormal result
    (3.0, 1e-40),
]


@pytest.mark.parametrize("a,b", ADD_CASES)
def test_xla_add_flushes_like_the_reference(a, b):
    x = np.float32([a])
    y = np.float32([b])
    want = np.asarray(jnp.asarray(x) + jnp.asarray(y))
    got = xla_float.add(torch.from_numpy(x), torch.from_numpy(y))
    assert np_of(got).tobytes() == want.tobytes()


@pytest.mark.parametrize("a,b", ADD_CASES)
def test_xla_add_scalar_flushes_like_the_reference(a, b):
    x = np.float32([a])
    y = np.float32([b])
    want = np.asarray(jnp.asarray(x) + jnp.asarray(y))
    got = xla_float.add_scalar(x[0], y[0])
    assert np.float32(got).tobytes() == want.tobytes()


def test_from_dense_drops_subnormals_like_the_reference():
    dense = np.float32([[0.0, 1e-40, 2.0]])
    ref = JS.from_dense(jnp.asarray(dense), cap=3)
    port = TS.from_dense(torch.from_numpy(dense), cap=3)
    assert_same_coo(ref, port)
    assert int(port.nnz) == 1


def two_subnormal_matrices():
    """Two 1x2 matrices, each holding 1e-40 at key 0."""
    keys = np.int32([0, 2])
    vals = np.float32([1e-40, 0.0])
    mats = [JS.PaddedCOO(jnp.asarray(keys), jnp.asarray(vals),
                         jnp.int32(1), (1, 2)) for _ in range(2)]
    return mats, to_port(mats)


@pytest.mark.parametrize("algorithm", ["sorted", "tree", "incremental",
                                       "auto"])
def test_engine_sums_of_subnormals_match_the_reference(algorithm):
    ref_in, port_in = two_subnormal_matrices()
    ref = JE.spkadd_run(ref_in, algorithm=algorithm)
    port = TE.spkadd_run(port_in, algorithm=algorithm)
    assert_same_coo(ref, port, algorithm)


def test_spa_sum_of_subnormals_drops_it_like_the_reference():
    ref_in, port_in = two_subnormal_matrices()
    ref = ref_spkadd(ref_in, algorithm="spa")
    port = TA.spkadd(port_in, algorithm="spa")
    assert_same_coo(ref, port)
    assert int(port.nnz) == 0


def test_apply_delta_flat_flushes_like_the_reference():
    flat = np.float32([1e-40, 1.0, 0.0])
    idx, val = np.int32([0, 2]), np.float32([1e-40, 1e-40])
    ref = JD.apply_delta_flat(jnp.asarray(flat), idx, val)
    port = TD.apply_delta_flat(torch.from_numpy(flat), idx, val)
    assert np_of(port).tobytes() == np.asarray(ref).tobytes()
    assert np_of(port).view(np.uint32).tolist() == [0, 0x3F800000, 0]


def subnormal_stream(seed, cap, mn):
    """Keys in [0, mn) and values mixing normals, subnormals of both signs
    and pairs whose sum is subnormal."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, mn, cap).astype(np.int32)
    vals = rng.choice(np.float32([1e-40, -1e-40, 1.5e-38, -1.4e-38, -0.0,
                                  2.0, -3e-39]), cap)
    return keys, vals.astype(np.float32)


def test_plain_folds_match_the_reference_on_subnormals():
    """Every plain version that adds, against the reference's key-grouped
    segment_sum (``kernels/ref.hash_accumulate_ref``) of the same stream."""
    mn, cap = 16, 256
    keys, vals = subnormal_stream(1, cap, mn)
    rk, rv, rn = JR.hash_accumulate_ref(jnp.asarray(keys), jnp.asarray(vals),
                                        sent=mn)
    n = int(rn)
    want = np.zeros(mn, np.float32)
    want[np.asarray(rk)[:n]] = np.asarray(rv)[:n]
    tk, tv = torch.from_numpy(keys), torch.from_numpy(vals)

    def by_key(tkeys, tvals):
        out = np.zeros(mn, np.float32)
        tk_, tv_ = np_of(tkeys).reshape(-1), np_of(tvals).reshape(-1)
        occ = (tk_ >= 0) & (tk_ < mn)
        out[tk_[occ]] = tv_[occ]
        return out

    order = np.argsort(keys, kind="stable")
    got = {
        "segment_fold": np_of(segment.segment_fold_plain(
            torch.from_numpy(vals[order]), torch.from_numpy(keys[order]),
            mn)),
        "hash_accumulate": by_key(*hash_accum.hash_accumulate_plain(
            tk, tv, sent=mn)),
        "hash_slide": by_key(*hash_slide.hash_slide_plain(
            tk[None], tv[None], mn=mn, table_size=32, part_span=mn, parts=1,
            chunk=64)),
        "spa_accumulate": np_of(spa_accum.spa_accumulate_plain(
            tk, tv, m=mn, n=1, block_rows=8, chunk=64)).reshape(-1),
    }
    steps = TS.partition_steps(torch.from_numpy(keys[order])[None], mn=mn,
                               part_elems=8, parts=2, chunk=64)
    got["partition"] = np_of(partition.partitioned_accumulate_plain(
        torch.from_numpy(keys[order])[None], torch.from_numpy(vals[order])[None],
        steps.chunk_id, steps.part_id, mn=mn, part_elems=8, parts=2,
        chunk=64)).reshape(-1)[:mn]
    for name, out in got.items():
        assert out.tobytes() == want.tobytes(), name


# ---------------------------------------------------------------------------
# B. bf16 NaN signs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algorithm", ["sorted", "tree", "incremental",
                                       "spa"])
@pytest.mark.parametrize("first,second", [
    (0xFFC0, 0x3F80),   # -NaN + 1.0
    (0x7F80, 0xFF80),   # +inf + -inf
])
def test_bf16_nan_sign_matches_the_reference(algorithm, first, second):
    mats = [JS.PaddedCOO(jnp.asarray(np.int32([0, 2])),
                         jnp.asarray(bf16([b, 0])), jnp.int32(1), (1, 2))
            for b in (first, second)]
    ref = ref_spkadd(mats, algorithm=algorithm)
    port = TA.spkadd(to_port(mats), algorithm=algorithm)
    assert_same_coo(ref, port, algorithm)
    assert bits(port.vals)[0] == np.int16(-64)  # 0xffc0


@pytest.mark.parametrize("first,second", [(0xFFC0, 0x3F80), (0x7F80, 0xFF80),
                                          (0x3F80, 0xFFC1)])
def test_bf16_segment_fold_keeps_the_nan_sign(first, second):
    """The plain ordered fold alone, against ``jax.ops.segment_sum``."""
    vals = bf16([first, second, 0x4000])
    gid = np.int32([0, 0, 1])
    want = jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(gid), 2)
    got = segment.segment_fold_plain(
        torch.from_numpy(vals.view(np.int16)).view(torch.bfloat16),
        torch.from_numpy(gid), 2)
    np.testing.assert_array_equal(bits(got), bits(want))


def test_round_bf16_matches_xla():
    x = f32([0x7FC00001, 0xFFC10000, 0xFF800001, 0x3F808000, 0x3F818000,
             0x7F7FFFFF, 0x00000001, 0x80000000])
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16)).view(np.uint16)
    got = bits(xla_float.round_bf16(torch.from_numpy(x))).view(np.uint16)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# C. bf16 PaddedCOOs through interop
# ---------------------------------------------------------------------------

def test_padded_coo_from_numpy_keeps_bf16_bits():
    vals = bf16([0x3F80, 0xFFC1, 0x0001, 0x8000])
    ref = JS.PaddedCOO(jnp.asarray(np.int32([0, 1, 2, 6])),
                       jnp.asarray(vals), jnp.int32(3), (2, 3))
    port = interop.padded_coo_from_numpy(*ref, device=CPU)
    assert port.vals.dtype == torch.bfloat16
    np.testing.assert_array_equal(port.vals.view(torch.int16).numpy(),
                                  np.asarray(ref.vals).view(np.int16))
    np.testing.assert_array_equal(np_of(port.keys), np.asarray(ref.keys))


# ---------------------------------------------------------------------------
# D. reference params trees through interop
# ---------------------------------------------------------------------------

def test_params_from_numpy_takes_a_reference_params_tree():
    tree = {"w": jnp.ones(3),
            "blocks": [{"b": jnp.arange(4, dtype=jnp.float32)},
                       (jnp.zeros((2, 2), jnp.bfloat16),)]}
    port = interop.params_from_numpy(tree, device=CPU)
    want = jax.tree_util.tree_leaves(tree)
    got_leaves, names, _ = port_tree.flatten_with_names(port)
    assert names == [jax.tree_util.keystr(p) for p, _ in
                     jax.tree_util.tree_flatten_with_path(tree)[0]]
    for w, g in zip(want, got_leaves):
        w = np.asarray(w)
        assert g.shape == w.shape
        gb = g.view(torch.int16).numpy() if g.dtype == torch.bfloat16 \
            else g.numpy()
        assert gb.tobytes() == w.tobytes()
