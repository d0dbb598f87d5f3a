"""The port's train steps (``repro_torch.train.step``) against the
reference's (``repro.train.step``), on the CPU.

- ``make_train_step`` against the reference's jitted step, one and three
  steps, with and without microbatch accumulation (params and AdamW state);
  the loss falls on a repeated batch (the twin of
  ``tests/test_models_smoke.py::test_loss_decreases``).
- ``make_compressed_train_step`` in one gloo world of four ranks
  (``repro_torch.launch.world.spawn_world``; rank bodies in
  ``tests/_torch_world.py``), on a 1-D data mesh and a 2 × 2 ``("data",
  "model")`` mesh, against the reference's own ``make_compressed_train_step``
  run under four fake CPU devices in a subprocess; and at k 1.0 against
  the port's dense step, within the reference's own bound
  (``tests/test_distributed.py``).

Both sides start from the reference's seeded init (through ``interop``)
and take the same numpy batches. The steps are not bitwise: XLA and
PyTorch sum a product's terms in other orders, and Adam's normalized
update turns a gradient's last-bit differences into differences of a few
ulps of its step. :data:`TOL` states what that leaves.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_world as W
from conftest import run_multidevice
from repro.configs import get_smoke_config as ref_smoke
from repro.models import build_model as ref_build_model
from repro.optim import adamw_init as ref_adamw_init
from repro.train import TrainHParams as RefHP
from repro.train import make_train_step as ref_make_train_step
from repro_torch import interop
from repro_torch import tree as TR
from repro_torch.configs import get_smoke_config
from repro_torch.data import make_batch
from repro_torch.launch.world import spawn_world
from repro_torch.models import build_model
from repro_torch.models.common import ShapeConfig
from repro_torch.optim import adamw_init
from repro_torch.train import (TrainHParams, make_compressed_train_step,
                               make_train_step, rank_ef_state)

CPU = "cpu"
DENSE = ("smollm-135m", "internlm2-1.8b", "stablelm-3b")
#: Each element of a parameter, moment or residual leaf within this share
#: of the leaf's largest magnitude (measured: moments 2e-6); losses and
#: grad norms to RTOL_METRIC.
TOL, RTOL_METRIC = 1e-4, 1e-5
#: Parameters also within this share of the learning rate summed over the
#: steps taken: Adam divides each gradient by its own scale, so a gradient
#: that nearly cancels (its last bits differ between the two packages'
#: sums) moves its parameter by a different share of lr (measured on these
#: tokens: at most 1.4e-6 after three steps, where a weight leaf's 1e-4
#: is about 2e-5).
LR_TOL = 1e-3
#: The reference's own bound for lossless compression against the dense
#: step (``tests/test_distributed.py``), and its loss bound.
FULL_K_RTOL, FULL_K_ATOL, FULL_K_LOSS = 2e-4, 2e-5, 1e-4
#: A world's time limit: a stuck rank fails the tests, not the suite.
WORLD_TIMEOUT_S = 200
HP = dict(ce_chunk=16, attn_chunk=16, remat=True, total_steps=10, warmup=2)
SHAPE = (2, 32)


def scaled_err(ref, got) -> float:
    ref, got = np.asarray(ref, np.float32), np.asarray(got, np.float32)
    return float(np.abs(ref - got).max()) / (float(np.abs(ref).max()) or 1.0)


def assert_leaves_close(ref_leaves, got_leaves, tol=TOL, what="",
                        lr_sum=0.0):
    """Each leaf within ``tol`` of its largest magnitude, plus
    ``LR_TOL * lr_sum`` (parameters after steps whose rates sum to
    ``lr_sum``)."""
    assert len(ref_leaves) == len(got_leaves)
    for i, (r, g) in enumerate(zip(ref_leaves, got_leaves)):
        r = np.asarray(r, np.float32)
        assert r.shape == g.shape, (what, i)
        err = float(np.abs(r - g).max())
        bound = tol * (float(np.abs(r).max()) or 1.0) + LR_TOL * lr_sum
        assert err <= bound, (what, i, err, bound)


def ref_params(arch):
    return ref_build_model(ref_smoke(arch)).init(jax.random.PRNGKey(0))


# ---------------------------------------------------------------------------
# the plain step
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def plain_steps(arch: str, grad_accum: int, steps: int = 3):
    """Per step: (reference, port) params, moments and metrics."""
    rm = ref_build_model(ref_smoke(arch))
    m = build_model(get_smoke_config(arch))
    rp = rm.init(jax.random.PRNGKey(0))
    p = interop.params_from_numpy(jax.tree.map(np.asarray, rp), CPU)
    rstep = jax.jit(ref_make_train_step(rm, RefHP(**HP,
                                                  grad_accum=grad_accum)))
    step = make_train_step(m, TrainHParams(**HP, grad_accum=grad_accum))
    ro, o = ref_adamw_init(rp), adamw_init(p)
    # fixed tokens: make_batch's seed is Python's salted hash, so its draws
    # change from process to process (make_batch itself is held bitwise in
    # tests/test_torch_models.py)
    B, S = SHAPE
    toks = np.random.default_rng(7).integers(0, 128, (B, S + 1),
                                             dtype=np.int32)
    b = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
         "labels": torch.from_numpy(toks[:, 1:].copy())}
    rb = {k: jnp.asarray(v.numpy()) for k, v in b.items()}
    out, lr_sum = [], 0.0
    for _ in range(steps):
        rp, ro, rmet = rstep(rp, ro, rb)
        p, o, met = step(p, o, b)
        lr_sum += float(rmet["lr"])
        out.append({
            "lr_sum": lr_sum,
            "ref": (jax.tree.leaves(rp), jax.tree.leaves(ro.mu)
                    + jax.tree.leaves(ro.nu), int(ro.step),
                    {k: float(v) for k, v in rmet.items()}),
            "port": ([x.numpy() for x in TR.leaves(p)],
                     [x.numpy() for x in TR.leaves(o.mu) + TR.leaves(o.nu)],
                     int(o.step), {k: float(v) for k, v in met.items()})})
    return out


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("arch", DENSE)
def test_train_step_matches_reference(arch, n_steps):
    r = plain_steps(arch, 1)[n_steps - 1]
    (rp, rmom, rstep, rmet), (p, mom, step, met) = r["ref"], r["port"]
    assert step == rstep == n_steps
    assert_leaves_close(rp, p, what="params", lr_sum=r["lr_sum"])
    assert_leaves_close(rmom, mom, what="moments")
    assert set(met) == set(rmet) == {"loss", "grad_norm", "lr"}
    for k in rmet:
        assert abs(met[k] - rmet[k]) <= RTOL_METRIC * abs(rmet[k]), k


@pytest.mark.parametrize("n_steps", [1, 3])
def test_grad_accum_matches_reference(n_steps):
    r = plain_steps("smollm-135m", 2)[n_steps - 1]
    (rp, rmom, _, rmet), (p, mom, _, met) = r["ref"], r["port"]
    assert_leaves_close(rp, p, what="params", lr_sum=r["lr_sum"])
    assert_leaves_close(rmom, mom, what="moments")
    for k in rmet:
        assert abs(met[k] - rmet[k]) <= RTOL_METRIC * abs(rmet[k]), k
    # two microbatches of the same batch: the same step as one batch
    one = plain_steps("smollm-135m", 1)[n_steps - 1]["port"]
    assert_leaves_close(one[0], p, what="accumulated vs whole",
                        lr_sum=r["lr_sum"])


@pytest.mark.parametrize("arch", DENSE)
def test_loss_decreases(arch):
    """Three steps on one repeated batch must reduce the loss."""
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    params = model.init(0, device=CPU)
    batch = make_batch(cfg, ShapeConfig("smoke", "train", 32, 2), 0,
                       device=CPU)
    step = make_train_step(model, TrainHParams(
        ce_chunk=16, attn_chunk=16, remat=False, peak_lr=3e-3,
        total_steps=100, warmup=0, weight_decay=0.0))
    opt = adamw_init(params)
    losses = []
    for _ in range(3):
        params, opt, metrics = step(params, opt, batch)
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert int(opt.step) == 3


def test_bf16_step_differentiates_the_rounded_copy():
    """In bf16 compute the gradients are taken w.r.t. the bf16 copy, so
    every gradient the optimizer sees is a bf16 value cast to f32."""
    import dataclasses

    from repro_torch.train import step as ST

    cfg = dataclasses.replace(get_smoke_config("smollm-135m"),
                              compute_dtype="bfloat16")
    model = build_model(cfg)
    params = model.init(0, device=CPU)
    batch = make_batch(cfg, ShapeConfig("smoke", "train", 32, 2), 0,
                       device=CPU)
    seen = {}
    real = ST.adamw_update

    def spy(p, grads, state, **kw):
        seen["grads"] = TR.leaves(grads)
        return real(p, grads, state, **kw)

    ST.adamw_update = spy
    try:
        make_train_step(model, TrainHParams(**HP))(params, adamw_init(params),
                                                   batch)
    finally:
        ST.adamw_update = real
    for g in seen["grads"]:
        assert g.dtype == torch.float32
        assert torch.equal(g, g.to(torch.bfloat16).to(torch.float32))


# ---------------------------------------------------------------------------
# the compressed step over a gloo world
# ---------------------------------------------------------------------------

REF_COMPRESSED = r"""
import jax, jax.numpy as jnp, numpy as np, sys
sys.path.insert(0, {tests!r})
import _torch_world as W
from repro.configs import get_smoke_config
from repro.models import build_model
from repro.optim import adamw_init
from repro.train import TrainHParams, init_ef_state, make_compressed_train_step

model = build_model(get_smoke_config(W.TRAIN_ARCH))
params = model.init(jax.random.PRNGKey(0))
out = {{}}
for name, shape in W.TRAIN_MESHES.items():
    dims = ("data",) if len(shape) == 1 else ("data", "model")
    mesh = jax.make_mesh(shape, dims)
    step = jax.jit(make_compressed_train_step(
        model, mesh, TrainHParams(**W.TRAIN_HP), k_fraction=W.TRAIN_K,
        selector="block", min_compress_elems=W.TRAIN_MIN_COMPRESS))
    ef = init_ef_state(params, shape[0], model_shards=shape[-1]
                       if len(shape) == 2 else 1)
    p, o = params, adamw_init(params)
    for s in range(W.TRAIN_STEPS):
        batch = {{k: jnp.asarray(v) for k, v in W.train_batch(s).items()}}
        p, o, ef, met = step(p, o, ef, batch)
        out[f"{{name}}/loss/{{s}}"] = np.float32(met["loss"])
        out[f"{{name}}/grad_norm/{{s}}"] = np.float32(met["grad_norm"])
    for kind, tree in (("params", p), ("mu", o.mu), ("nu", o.nu),
                       ("ef", ef)):
        for i, leaf in enumerate(jax.tree.leaves(tree)):
            out[f"{{name}}/{{kind}}/{{i}}"] = np.asarray(leaf)
np.savez({path!r}, **out)
print("ok")
"""


@pytest.fixture(scope="module")
def compressed(tmp_path_factory):
    """(the port's four ranks' results, the reference's arrays)."""
    params = jax.tree.map(np.asarray, ref_params(W.TRAIN_ARCH))
    port = spawn_world(W.compressed_train_rank, W.TRAIN_WORLD, params,
                       timeout=WORLD_TIMEOUT_S)
    path = str(tmp_path_factory.mktemp("ref_compressed") / "ref.npz")
    tests = os.path.dirname(os.path.abspath(__file__))
    run_multidevice(REF_COMPRESSED.format(tests=tests, path=path),
                    n_devices=W.TRAIN_WORLD)
    with np.load(path) as f:
        ref = {k: f[k] for k in f.files}
    return port, ref


def compressed_lr_sum() -> float:
    """The learning rates of the compressed run's steps, summed."""
    from repro_torch.optim import cosine_schedule

    hp = W.TRAIN_HP
    return sum(float(cosine_schedule(
        torch.tensor(s), peak_lr=TrainHParams().peak_lr, warmup=hp["warmup"],
        total=hp["total_steps"])) for s in range(W.TRAIN_STEPS))


def _ref_leaves(ref, name, kind):
    n = sum(1 for k in ref if k.startswith(f"{name}/{kind}/"))
    return [ref[f"{name}/{kind}/{i}"] for i in range(n)]


@pytest.mark.parametrize("mesh", sorted(W.TRAIN_MESHES))
def test_compressed_step_params_and_state_match_reference(compressed, mesh):
    port, ref = compressed
    for rank, res in enumerate(port):
        r = res[mesh]
        assert_leaves_close(_ref_leaves(ref, mesh, "params"), r["params"],
                            what=f"{mesh} params rank {rank}",
                            lr_sum=compressed_lr_sum())
        assert_leaves_close(_ref_leaves(ref, mesh, "mu"), r["mu"],
                            what=f"{mesh} mu rank {rank}")
        assert_leaves_close(_ref_leaves(ref, mesh, "nu"), r["nu"],
                            what=f"{mesh} nu rank {rank}")


@pytest.mark.parametrize("mesh", sorted(W.TRAIN_MESHES))
def test_compressed_step_metrics_match_reference(compressed, mesh):
    port, ref = compressed
    for res in port:
        for s in range(W.TRAIN_STEPS):
            for k in ("loss", "grad_norm"):
                want = float(ref[f"{mesh}/{k}/{s}"])
                got = res[mesh][k][s]
                assert abs(got - want) <= RTOL_METRIC * abs(want), (k, s)


@pytest.mark.parametrize("mesh", sorted(W.TRAIN_MESHES))
def test_compressed_step_residuals_are_each_ranks_shard(compressed, mesh):
    """Each rank's residuals are its row (1-D) or its (data, model) cell
    (2-D) of the reference's global error-feedback state."""
    port, ref = compressed
    shape = W.TRAIN_MESHES[mesh]
    ref_ef = _ref_leaves(ref, mesh, "ef")
    coords = set()
    for rank, res in enumerate(port):
        coord = res[mesh]["coord"]
        coords.add(coord)
        assert coord == (np.unravel_index(rank, shape)), (rank, coord)
        want = [leaf[coord][None] if len(shape) == 1 else
                leaf[coord][None, None] for leaf in ref_ef]
        assert_leaves_close(want, res[mesh]["ef"],
                            what=f"{mesh} ef rank {rank}")
    assert len(coords) == W.TRAIN_WORLD


def test_compressed_step_replicates_params_on_every_rank(compressed):
    port, _ = compressed
    for mesh in W.TRAIN_MESHES:
        first = port[0][mesh]["params"]
        for res in port[1:]:
            for a, b in zip(first, res[mesh]["params"]):
                assert a.tobytes() == b.tobytes(), mesh


def test_lossless_compression_matches_the_dense_step(compressed):
    """k 1.0: the compressed step on four ranks tracks the dense step on
    the whole batch, within the reference's own bound."""
    port, _ = compressed
    model = build_model(get_smoke_config(W.TRAIN_ARCH))
    params = interop.params_from_numpy(
        jax.tree.map(np.asarray, ref_params(W.TRAIN_ARCH)), CPU)
    step = make_train_step(model, TrainHParams(**W.FULL_K_HP))
    opt = adamw_init(params)
    losses = []
    for s in range(W.FULL_K_STEPS):
        batch = {k: torch.from_numpy(v) for k, v in W.train_batch(s).items()}
        params, opt, met = step(params, opt, batch)
        losses.append(float(met["loss"]))
    for res in port:
        full = res["full_k"]
        for a, b in zip(losses, full["loss"]):
            assert abs(a - b) < FULL_K_LOSS
        for a, b in zip(TR.leaves(params), full["params"]):
            np.testing.assert_allclose(a.numpy(), b, rtol=FULL_K_RTOL,
                                       atol=FULL_K_ATOL)


def test_rank_ef_state_layout():
    params = {"w": torch.zeros(5, 3), "b": torch.zeros(7)}
    one = rank_ef_state(params)
    two = rank_ef_state(params, model_shards=2)
    assert one["w"].shape == (1, 15) and one["b"].shape == (1, 7)
    assert two["w"].shape == (1, 1, 8) and two["b"].shape == (1, 1, 4)
    assert all(x.dtype == torch.float32 and not x.any()
               for x in TR.leaves(one) + TR.leaves(two))


def test_compressed_step_needs_a_data_dim():
    class Mesh:
        mesh_dim_names = ("model",)

    with pytest.raises(ValueError, match="'data' dim"):
        make_compressed_train_step(build_model(get_smoke_config(
            "smollm-135m")), Mesh())
