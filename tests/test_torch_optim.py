"""The port's AdamW (``repro_torch.optim``) against the reference
(``repro.optim``), on the CPU, and the interop of its state.

The reference runs jitted, as its train steps run it. The port repeats
its arithmetic expression for expression, with XLA's subnormal flush, but
not bitwise: the global norm sums each leaf in another order (which moves
the clip scale by an ulp), and ``pow``, ``cos`` and ``sqrt`` may differ in
their last bit. :data:`TOL` states what that leaves.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_bytes_equal
from repro.optim import adamw as RA
from repro_torch import interop
from repro_torch.optim import adamw as TA

CPU = "cpu"
SHAPES = {"w": (64, 96), "b": (96,),
          "layers": {"w1": (3, 32, 48), "ln": (3, 32)}}
SCHED = dict(peak_lr=3e-3, warmup=2, total=6)
STEPS = 4  # warmup, then the cosine decay
#: Each element within this share of its leaf's largest magnitude: a few
#: f32 ulps of the leaf's scale (measured: at most 3e-7 over four steps).
TOL = 1e-6


def tree_of(rng, shapes, scale=1.0):
    if isinstance(shapes, dict):
        return {k: tree_of(rng, v, scale) for k, v in shapes.items()}
    return (scale * rng.standard_normal(shapes)).astype(np.float32)


def np_leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def assert_leaf_close(want, got, msg):
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape and want.dtype == got.dtype, msg
    scale = float(np.max(np.abs(want))) or 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale,
                               err_msg=msg)


def ref_step(p, g, s):
    lr = RA.cosine_schedule(s.step, **SCHED)
    new_p, new_s, gn = RA.adamw_update(p, g, s, lr=lr)
    return new_p, new_s, gn, lr


def run_both(params, grads):
    """One update in both packages for each tree of ``grads``; yields
    each step's results."""
    rp = jax.tree.map(jnp.asarray, params)
    rs = RA.adamw_init(rp)
    tp = interop.params_from_numpy(params, device=CPU)
    ts = TA.adamw_init(tp)
    f = jax.jit(ref_step)
    for g in grads:
        rp, rs, rgn, rlr = f(rp, jax.tree.map(jnp.asarray, g), rs)
        tlr = TA.cosine_schedule(ts.step, **SCHED)
        tp, ts, tgn = TA.adamw_update(
            tp, interop.params_from_numpy(g, device=CPU), ts, lr=tlr)
        yield (rp, rs, rgn, rlr), (tp, ts, tgn, tlr)


@pytest.mark.parametrize("seed", [0, 1])
def test_adamw_matches_reference_over_steps(seed):
    rng = np.random.default_rng(seed)
    params = tree_of(rng, SHAPES)
    grads = [tree_of(rng, SHAPES, scale=0.5) for _ in range(STEPS)]
    for i, (ref, port) in enumerate(run_both(params, grads)):
        (rp, rs, rgn, rlr), (tp, ts, tgn, tlr) = ref, port
        assert int(ts.step) == int(rs.step) == i + 1
        assert ts.step.dtype == torch.int32
        np.testing.assert_allclose(float(tgn), float(rgn), rtol=TOL)
        np.testing.assert_allclose(float(tlr), float(rlr), rtol=TOL)
        for name, r, t in (("params", rp, tp), ("mu", rs.mu, ts.mu),
                           ("nu", rs.nu, ts.nu)):
            for j, (a, b) in enumerate(zip(np_leaves(r), np_leaves(
                    interop.params_to_numpy(t)))):
                assert_leaf_close(a, b, f"step {i} {name} leaf {j}")


@pytest.mark.parametrize("step", range(9))
def test_cosine_schedule_matches_reference(step):
    kw = dict(peak_lr=3e-3, warmup=3, total=7, floor=0.1)
    want = jax.jit(lambda s: RA.cosine_schedule(s, **kw))(
        jnp.asarray(step, jnp.int32))
    got = TA.cosine_schedule(torch.tensor(step, dtype=torch.int32), **kw)
    assert got.dtype == torch.float32
    if step < kw["warmup"]:
        # the warmup is one product by XLA's folded constant: bitwise
        assert_bytes_equal(np.asarray(want), got, f"step {step}")
    else:
        # the decay takes XLA's cos and the multiply-add it fuses, whose
        # last bits PyTorch's do not share (measured: at most 5 ulps)
        np.testing.assert_allclose(float(got), float(want), rtol=TOL)


@pytest.mark.parametrize("max_norm", [0.5, 1e4])
def test_clip_by_global_norm_matches_reference(max_norm):
    rng = np.random.default_rng(3)
    grads = tree_of(rng, SHAPES)
    want, want_gn = jax.jit(lambda g: RA.clip_by_global_norm(g, max_norm))(
        jax.tree.map(jnp.asarray, grads))
    got, gn = TA.clip_by_global_norm(
        interop.params_from_numpy(grads, device=CPU), max_norm)
    np.testing.assert_allclose(float(gn), float(want_gn), rtol=TOL)
    for a, b in zip(np_leaves(want),
                    np_leaves(interop.params_to_numpy(got))):
        assert_leaf_close(a, b, f"max_norm {max_norm}")


def test_adamw_init_is_fp32_zeros_on_each_leaf():
    params = {"w": torch.ones(3, 4, dtype=torch.bfloat16), "b": torch.ones(4)}
    st = TA.adamw_init(params)
    assert st.step.dtype == torch.int32 and int(st.step) == 0
    for tree_ in (st.mu, st.nu):
        assert tree_["w"].dtype == torch.float32 and tree_["w"].shape == (3, 4)
        assert not tree_["w"].any() and not tree_["b"].any()


def test_adamw_flushes_subnormal_gradients_like_the_reference():
    """A subnormal gradient is a zero to XLA: its moments stay +0.0 and
    the parameter moves by decay alone, bitwise as in the reference."""
    params = {"w": np.full((4, 4), 0.5, np.float32)}
    g = np.zeros((4, 4), np.float32)
    g[0] = [1e-40, -1e-40, 5e-39, -3e-39]
    g[1] = [1.0, -2.0, 0.5, 0.25]
    # step 1 runs at lr 0 (warmup from step 0): take a second
    (rp, rs, _, _), (tp, ts, _, _) = list(
        run_both(params, [{"w": g}] * 2))[-1]
    for r, t in ((rp, tp), (rs.mu, ts.mu), (rs.nu, ts.nu)):
        assert_bytes_equal(np.asarray(r["w"])[0], t["w"][0], "subnormal row")
    assert not ts.mu["w"][0].any()


def test_bf16_params_cast_back_as_the_reference():
    rng = np.random.default_rng(4)
    p32 = tree_of(rng, {"w": (16, 32)})
    grads = [tree_of(rng, {"w": (16, 32)}) for _ in range(3)]
    params = {"w": jnp.asarray(p32["w"], jnp.bfloat16)}
    *_, (ref, port) = run_both(params, grads)
    want = np.asarray(ref[0]["w"]).astype(np.float32)
    got = port[0]["w"]
    assert got.dtype == torch.bfloat16
    # one bf16 ulp: an f32 result a few ulps off can round to the
    # neighbouring bf16 value
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=0)


def test_adamw_state_and_ef_residuals_round_trip_bitwise():
    """The reference's AdamW state and error-feedback residuals to the
    port and back, every bit kept."""
    from repro.train.step import init_ef_state

    rng = np.random.default_rng(5)
    params = jax.tree.map(jnp.asarray, tree_of(rng, SHAPES))
    grads = jax.tree.map(jnp.asarray, tree_of(rng, SHAPES))
    _, state, _ = jax.jit(lambda p, g, s: RA.adamw_update(
        p, g, s, lr=1e-3))(params, grads, RA.adamw_init(params))
    ported = interop.adamw_state_from_numpy(state, device=CPU)
    assert isinstance(ported, TA.AdamWState)
    assert ported.step.dtype == torch.int32 and int(ported.step) == 1
    back = RA.AdamWState(*interop.adamw_state_to_numpy(ported))
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(back)):
        assert_bytes_equal(np.asarray(a), b, "adamw state")
    ef = jax.tree.map(lambda r: r + 0.25, init_ef_state(params, 4))
    ef_back = interop.params_to_numpy(interop.params_from_numpy(
        ef, device=CPU))
    for a, b in zip(jax.tree.leaves(ef), jax.tree.leaves(ef_back)):
        assert_bytes_equal(np.asarray(a), b, "ef residuals")
