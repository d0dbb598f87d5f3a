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


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

def tree_leaves(tree):
    """The leaves of a cache or params tree of either package in JAX's
    order: dicts by sorted key, tuples (NamedTuples included) and lists in
    order, ``None`` skipped."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [a for c in tree for a in tree_leaves(c)]
    return [tree]


def tree_arrays(tree):
    """:func:`tree_leaves` as numpy arrays, floats as float32."""
    out = []
    for x in tree_leaves(tree):
        a = np_of(x.float() if isinstance(x, torch.Tensor)
                  and x.is_floating_point() else x)
        out.append(a.astype(np.float32) if a.dtype.kind == "f" else a)
    return out


#: A compressed step's parameters, moments and residuals: each leaf within
#: STEP_TOL of its largest magnitude, parameters also within STEP_LR_TOL
#: of the learning rates summed (tests/test_torch_train_step.py's bounds).
STEP_TOL, STEP_LR_TOL = 1e-4, 1e-3


def compressed_steps(arch: str, batches, hp: dict, k_fraction: float,
                     min_compress_elems: int, n_steps: int = 2):
    """``n_steps`` compressed train steps (block selector, ``gather_kway``)
    of ``arch``'s smoke config, on the reference's init: the reference's
    ``make_compressed_train_step`` on a one-device mesh and the port's at
    world size 1 (a gloo world of one rank). ``batches(cfg, step)`` gives
    the step's ``(reference batch, port batch)``. Returns one dict a step:
    ``lr_sum`` and, for ``ref`` and ``port``, the leaves of params, mu, nu
    and the residuals, then the metrics."""
    from repro import configs as RC
    from repro.models import build_model as ref_build_model
    from repro.optim import adamw_init as ref_adamw_init
    from repro.train import TrainHParams as RefHP
    from repro.train import init_ef_state as ref_init_ef
    from repro.train import make_compressed_train_step as ref_make
    from repro_torch import configs as TC
    from repro_torch import tree as TR
    from repro_torch.launch.world import process_world
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init, cosine_schedule
    from repro_torch.train import (TrainHParams, make_compressed_train_step,
                                   rank_ef_state)

    rm = ref_build_model(RC.get_smoke_config(arch))
    cfg = TC.get_smoke_config(arch)
    m = build_model(cfg)
    rp = rm.init(jax.random.PRNGKey(0))
    p = interop.params_from_numpy(jax.tree.map(np.asarray, rp), CPU)
    mesh = jax.make_mesh((1,), ("data",))
    kw = dict(k_fraction=k_fraction, selector="block",
              min_compress_elems=min_compress_elems)
    rstep = jax.jit(ref_make(rm, mesh, RefHP(**hp), **kw))
    ro, ref_ef = ref_adamw_init(rp), ref_init_ef(rp, 1)
    out = []
    with process_world("cpu"):
        step = make_compressed_train_step(m, None, TrainHParams(**hp), **kw)
        o, ef = adamw_init(p), rank_ef_state(p)
        lr_sum = 0.0
        for s in range(n_steps):
            rb, tb = batches(cfg, s)
            rp, ro, ref_ef, rmet = rstep(rp, ro, ref_ef, rb)
            p, o, ef, met = step(p, o, ef, tb)
            lr_sum += float(cosine_schedule(
                torch.tensor(s), peak_lr=TrainHParams().peak_lr,
                warmup=hp["warmup"], total=hp["total_steps"]))
            out.append({
                "lr_sum": lr_sum,
                "ref": [jax.tree.leaves(t) for t in (rp, ro.mu, ro.nu,
                                                     ref_ef)]
                + [{k: float(v) for k, v in rmet.items()}],
                "port": [[x.numpy() for x in TR.leaves(t)]
                         for t in (p, o.mu, o.nu, ef)]
                + [{k: float(v) for k, v in met.items()}]})
    return out


def assert_step_close(ref_leaves, got_leaves, what, lr_sum=0.0):
    """Each leaf within :data:`STEP_TOL` of its largest magnitude (plus
    :data:`STEP_LR_TOL` of ``lr_sum``)."""
    assert len(ref_leaves) == len(got_leaves)
    for i, (r, g) in enumerate(zip(ref_leaves, got_leaves)):
        r = np.asarray(r, np.float32)
        assert r.shape == g.shape, (what, i)
        err = float(np.abs(r - g).max())
        bound = STEP_TOL * (float(np.abs(r).max()) or 1.0) \
            + STEP_LR_TOL * lr_sum
        assert err <= bound, (what, i, err, bound)


def assert_compressed_step(r, rtol: float):
    """One step of :func:`compressed_steps` held to the reference."""
    (rp, rmu, rnu, ref_ef, rmet) = r["ref"]
    (p, mu, nu, ef, met) = r["port"]
    assert_step_close(rp, p, "params", r["lr_sum"])
    assert_step_close(rmu, mu, "mu")
    assert_step_close(rnu, nu, "nu")
    assert_step_close(ref_ef, ef, "ef")
    for k in ("loss", "grad_norm"):
        assert abs(met[k] - rmet[k]) <= rtol * abs(rmet[k]), k


def bf16_decode_drift(arch: str, n_layers: int, d_model: int, prompt: int,
                      new_tokens: int = 8, seed: int = 0):
    """``(port gap, reference gap)``: each package's last decode logits,
    after a prefill of ``prompt`` tokens and ``new_tokens`` greedy decode
    steps, against its own prefill of the prompt plus those tokens, in
    bf16 compute, as max |diff| over the largest logit. ``arch``'s full
    config at ``n_layers`` and ``d_model`` (4 heads, ``d_ff`` 2 d, vocab
    2,048), on the reference's init; both decode the port's tokens."""
    import dataclasses

    from repro import configs as RC
    from repro.models import build_model as ref_build_model
    from repro_torch import configs as TC
    from repro_torch.models import build_model

    kw = dict(n_layers=n_layers, d_model=d_model, vocab=2048,
              compute_dtype="bfloat16")
    if RC.get_config(arch).n_heads:
        kw.update(n_heads=4, n_kv_heads=4, d_ff=2 * d_model)
    rm = ref_build_model(dataclasses.replace(RC.get_config(arch), **kw))
    m = build_model(dataclasses.replace(TC.get_config(arch), **kw))
    rp = rm.init(jax.random.PRNGKey(seed))
    p = interop.params_from_numpy(jax.tree.map(np.asarray, rp), CPU)
    toks = np.random.default_rng(seed).integers(0, 2048, (2, prompt),
                                                dtype=np.int32)
    lg, c = m.prefill(p, torch.from_numpy(toks), max_len=prompt + new_tokens,
                      attn_chunk=32)
    tok, fed = lg.argmax(-1), []
    for _ in range(new_tokens):
        fed.append(tok)
        lg, c = m.decode_step(p, c, tok, attn_chunk=128)
        tok = lg.argmax(-1)
    full = torch.cat([torch.from_numpy(toks), torch.stack(fed, 1).int()], 1)
    lp, _ = m.prefill(p, full, attn_chunk=32)
    port = float((lp - lg).abs().max()) / float(lp.abs().max())

    prefill = jax.jit(lambda q, t, n: rm.prefill(q, tokens=t, max_len=n,
                                                 attn_chunk=32),
                      static_argnums=2)
    decode = jax.jit(lambda q, cc, t: rm.decode_step(q, cc, t,
                                                     attn_chunk=128))
    rlg, rc = prefill(rp, jnp.asarray(toks), prompt + new_tokens)
    for t in fed:
        rlg, rc = decode(rp, rc, jnp.asarray(t.numpy()))
    rlp, _ = prefill(rp, jnp.asarray(full.numpy()), prompt + new_tokens)
    ref = float(jnp.abs(rlp - rlg).max() / jnp.abs(rlp).max())
    return port, ref
