"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``).

Inputs are made from numpy seeds, go through the JAX reference (``repro``)
and the port (``repro_torch``, on the CPU) as numpy arrays, and the outputs
are compared bitwise: keys and nnz exactly, values as bytes, because the
canonical contract promises bit-identity (+0.0 vs -0.0 and NaN payloads
count).
"""
import numpy as np
import jax
import jax.numpy as jnp
import torch

from repro.core import sparse as S
from repro.core.spkadd import spkadd_sorted
from repro_torch import interop

CPU = "cpu"

# The reference's functions jitted once per shape: eager JAX compiles every
# primitive it meets, which would dominate these tests' time.
jax_partition_steps = jax.jit(S.partition_steps, static_argnames=(
    "mn", "part_elems", "parts", "chunk"))
jax_plan_and_partition = jax.jit(S.plan_and_partition, static_argnames=(
    "shape", "part_elems", "chunk"))
jax_compress_plan = jax.jit(S.compress_plan, static_argnames=("shape",))
jax_compress = jax.jit(S.compress)
jax_sorted = jax.jit(spkadd_sorted)
jax_from_dense = jax.jit(S.from_dense, static_argnames=("cap",))


def dense_collection(seed, k, m, n, nnz):
    """k dense numpy matrices with ``nnz`` distinct-magnitude nonzeros."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        d = np.zeros((m, n), np.float32)
        take = min(nnz, m * n)
        idx = rng.choice(m * n, take, replace=False)
        d.flat[idx] = rng.standard_normal(take)
        out.append(d)
    return out


def jax_collection(seed, k, m, n, nnz):
    """The reference tests' ``random_collection``: ``from_dense`` of
    :func:`dense_collection`, capacity ``nnz`` each."""
    return [jax_from_dense(jnp.asarray(d), cap=nnz)
            for d in dense_collection(seed, k, m, n, nnz)]


def to_port(mats):
    """Reference PaddedCOOs -> port PaddedCOOs on the CPU."""
    return interop.collection_from_numpy(mats, device=CPU)


def np_of(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def assert_bytes_equal(a, b, msg=""):
    a, b = np_of(a), np_of(b)
    assert a.shape == b.shape, f"{msg}: shape {a.shape} vs {b.shape}"
    assert a.tobytes() == b.tobytes(), f"{msg}: bytes differ\n{a}\n{b}"


def assert_same_coo(ref, port, msg=""):
    """Reference PaddedCOO vs port PaddedCOO, bitwise."""
    assert tuple(ref.shape) == tuple(port.shape), msg
    np.testing.assert_array_equal(np_of(ref.keys), np_of(port.keys),
                                  err_msg=msg)
    np.testing.assert_array_equal(np_of(ref.nnz), np_of(port.nnz),
                                  err_msg=msg)
    assert_bytes_equal(ref.vals, port.vals, msg)
