"""The port's top-k sparsification stack against the reference, on the CPU.

- ``kernels/topk_block.py``: the plain version of the block top-k kernel
  (what ``ops.topk_block`` runs on a CPU tensor) against the reference's
  Pallas kernel in interpret mode (``topk_block_raw``) and its oracle
  (``ref.topk_block_ref``);
- ``core/topk.py``: ``topk_global``, ``topk_block``, ``densify`` and
  ``sparsify_with_feedback`` against ``repro.core.topk``, on inputs with
  ties, ``+0.0`` and ``-0.0``, sizes at, under and not a multiple of the
  block, and ``k`` past the size.

Inputs are made with numpy from a seed. Tolerance everywhere: bitwise.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import topk as J_topk
from repro.kernels import ref as J_ref
from repro.kernels.topk_block import topk_block_raw as J_topk_block_raw
from repro_torch.core import topk as T_topk
from repro_torch.kernels import ops as T_ops
from repro_torch.kernels import topk_block as T_kernel

from _torch_parity import assert_bytes_equal, np_of


def vector(seed, size, kind):
    """A float32 vector: ``normal``, ``ties`` (few distinct magnitudes of
    both signs, signed zeros among them), ``zeros`` (+0.0 and -0.0 only) or
    ``grid`` (the delta-sync benchmark's dyadic grid)."""
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return rng.standard_normal(size).astype(np.float32)
    if kind == "ties":
        mags = np.array([0.0, 0.5, 1.0, 2.0], np.float32)
        return (rng.choice(mags, size) * rng.choice([-1.0, 1.0], size)
                ).astype(np.float32)
    if kind == "zeros":
        return np.where(rng.random(size) < 0.5, 0.0, -0.0).astype(np.float32)
    return (rng.integers(-8, 8, size) * 2.0 ** -10).astype(np.float32)


def assert_same_update(ref, port, msg=""):
    np.testing.assert_array_equal(np.asarray(ref.idx), np_of(port.idx),
                                  err_msg=msg)
    assert np_of(port.idx).dtype == np.int32, msg
    assert_bytes_equal(ref.val, port.val, msg)
    assert int(ref.size) == int(port.size), msg


# ---------------------------------------------------------------------------
# the kernel's plain version vs the reference kernel (interpret) and oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size,block,k,kind", [
    (256, 64, 8, "normal"),
    (256, 64, 8, "ties"),
    (128, 32, 31, "ties"),      # per = block - 1
    (128, 32, 1, "normal"),
    (96, 32, 5, "zeros"),       # an all-zero block: lowest indices first
    (64, 64, 64, "ties"),       # k == block: the whole block, sorted
])
def test_topk_block_plain_matches_reference_kernel(size, block, k, kind):
    x = vector(size + k, size, kind)
    gi, gv = J_topk_block_raw(jnp.asarray(x), k=k, block=block)
    ri, rv = J_ref.topk_block_ref(jnp.asarray(x), k, block)
    pi, pv = T_kernel.topk_block_raw(torch.as_tensor(x), k=k, block=block)
    assert T_kernel.topk_block_raw.launches == 0  # CPU: the plain version
    for ref_i, ref_v, what in ((gi, gv, "kernel"), (ri, rv, "oracle")):
        np.testing.assert_array_equal(np.asarray(ref_i), np_of(pi),
                                      err_msg=what)
        assert_bytes_equal(ref_v, pv, what)


def test_topk_block_plain_nan_order_matches_reference_kernel():
    """NaN counts as the largest |x|, NaNs among themselves lowest index
    first — the rule the CUDA kernel's source states."""
    x = np.array([1.0, np.nan, -3.0, np.nan, 0.0, -np.nan, 2.0, 0.5],
                 np.float32)
    gi, gv = J_topk_block_raw(jnp.asarray(x), k=5, block=8)
    pi, pv = T_kernel.topk_block_raw(torch.as_tensor(x), k=5, block=8)
    np.testing.assert_array_equal(np.asarray(gi), np_of(pi))
    assert_bytes_equal(gv, pv)


def test_topk_block_raw_refuses_bad_shapes():
    with pytest.raises(ValueError, match="multiple of block"):
        T_kernel.topk_block_raw(torch.zeros(10), k=2, block=4)
    with pytest.raises(ValueError, match="must lie in"):
        T_kernel.topk_block_raw(torch.zeros(8), k=5, block=4)


def test_ops_topk_block_pads_to_a_block_multiple():
    x = vector(3, 150, "ties")
    idx, val = T_ops.topk_block(torch.as_tensor(x), k=4, block=64)
    xp = np.concatenate([x, np.zeros(42, np.float32)])
    ri, rv = J_ref.topk_block_ref(jnp.asarray(xp), 4, 64)
    np.testing.assert_array_equal(np.asarray(ri), np_of(idx))
    assert_bytes_equal(rv, val)


# ---------------------------------------------------------------------------
# core/topk.py vs repro.core.topk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size,k,kind", [
    (100, 7, "normal"), (100, 7, "ties"), (64, 64, "ties"),
    (50, 80, "normal"), (40, 5, "zeros"), (333, 33, "grid"),
])
def test_topk_global_matches_reference(size, k, kind):
    x = vector(size * 3 + k, size, kind)
    assert_same_update(J_topk.topk_global(jnp.asarray(x), k),
                       T_topk.topk_global(torch.as_tensor(x), k))


@pytest.mark.parametrize("size,k,block,kind", [
    (1000, 40, 128, "normal"),   # 8 blocks, not a block multiple
    (1000, 40, 128, "ties"),
    (1000, 5, 128, "normal"),    # k < nb: one per block
    (1024, 100, 128, "grid"),    # an exact block multiple
    (700, 60, 128, "zeros"),     # selected padding comes back as size
    (100, 10, 128, "ties"),      # size <= block: the global route
    (300, 300, 64, "normal"),    # k >= size: the global route
    (5000, 50, 4096, "ties"),    # the publisher's block, two blocks
])
def test_topk_block_matches_reference(size, k, block, kind):
    x = vector(size + k + block, size, kind)
    if size % 4 == 0:
        x = x.reshape(4, -1)  # selection is over the flattened tensor
    assert_same_update(J_topk.topk_block(jnp.asarray(x), k, block=block),
                       T_topk.topk_block(torch.as_tensor(x), k, block=block))


def test_topk_block_padding_is_size_and_zero():
    x = np.zeros(130, np.float32)
    x[:3] = [1.0, -2.0, 3.0]
    u = T_topk.topk_block(torch.as_tensor(x), 9, block=64)  # per = 3
    idx, val = np_of(u.idx), np_of(u.val)
    # the last block holds real zeros at 128 and 129, then padding
    assert list(idx[-3:]) == [128, 129, 130] and (val[-3:] == 0.0).all()
    assert_same_update(J_topk.topk_block(jnp.asarray(x), 9, block=64), u)


@pytest.mark.parametrize("selector", ["global", "block"])
def test_densify_adds_into_zeros(selector):
    """A selected -0.0 densifies to +0.0, as ``.at[].add`` gives it."""
    x = vector(9, 300, "zeros")
    x[::7] = vector(10, 300, "ties")[::7]
    ref_u = (J_topk.topk_global(jnp.asarray(x), 40) if selector == "global"
             else J_topk.topk_block(jnp.asarray(x), 40, block=64))
    port_u = (T_topk.topk_global(torch.as_tensor(x), 40)
              if selector == "global"
              else T_topk.topk_block(torch.as_tensor(x), 40, block=64))
    assert (np.signbit(np_of(port_u.val)) & (np_of(port_u.val) == 0)).any()
    assert_bytes_equal(J_topk.densify(ref_u), T_topk.densify(port_u))


@pytest.mark.parametrize("selector,size,k,block", [
    ("global", 500, 25, 4096),
    ("block", 500, 25, 128),
    ("block", 9000, 90, 4096),
    ("block", 300, 30, 64),
])
def test_sparsify_with_feedback_matches_reference(selector, size, k, block):
    rng = np.random.default_rng(size + k)
    residual_j = jnp.zeros(size, jnp.float32)
    residual_t = torch.zeros(size)
    for step in range(3):
        g = vector(step * 100 + size, size, "grid" if step else "ties")
        g[rng.random(size) < 0.2] = -0.0
        uj, residual_j = J_topk.sparsify_with_feedback(
            jnp.asarray(g), residual_j, k, selector=selector, block=block)
        ut, residual_t = T_topk.sparsify_with_feedback(
            torch.as_tensor(g), residual_t, k, selector=selector, block=block)
        assert_same_update(uj, ut, f"step {step}")
        assert_bytes_equal(residual_j, residual_t, f"residual, step {step}")


def test_sparsify_rejects_unknown_selector():
    with pytest.raises(ValueError, match="unknown selector"):
        T_topk.sparsify_with_feedback(torch.zeros(4), torch.zeros(4), 2,
                                      selector="nope")


@pytest.mark.parametrize("n,frac,shards", [
    (1000, 0.01, 1), (1000, 0.01, 3), (7, 0.01, 2), (4096, 1.0, 4),
    (10 ** 6, 0.003, 8),
])
def test_budgets_match_reference(n, frac, shards):
    assert T_topk.global_k(n, frac) == J_topk.global_k(n, frac)
    assert T_topk.per_shard_k(n, frac, shards) == \
        J_topk.per_shard_k(n, frac, shards)
