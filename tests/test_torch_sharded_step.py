"""The port's sharded dense step and what waits on sharding, on the CPU.

- ``make_train_step`` on DTensor parameters (``repro_torch.sharding``:
  FSDP×TP placements by ``params_shardings``) in gloo worlds of one, two
  and four ranks (``repro_torch.launch.world.spawn_world``; rank bodies in
  ``tests/_torch_world.py``), on ``("data", "model")`` meshes (2, 1),
  (1, 2), (2, 2) and (1, 1): two steps from the reference's smoke tree
  (through ``interop``) on the same global batch, held to the reference's
  unsharded ``make_train_step`` with ``tests/test_torch_train_step.py``'s
  tolerances; ``grad_accum=2``; a batch of 3 on data = 2, which is
  replicated and takes no mean; the grad norm bit-identical on every rank;
  the moments DTensors with the params' placements; at world 1 the DTensor
  path bitwise the plain path; the bytes one dense and one compressed step
  hand to their collectives. The MoE cases run moonshot's smoke config,
  three times with a capacity that binds, on (2, 1), on (2, 2) with
  ``grad_accum=2`` and at world 1 (bitwise the plain step): the capacity
  and the load-balance loss are the whole batch's, as under the
  reference's ``jit``.
- Elastic checkpoints (the twin of
  ``tests/test_substrate.py::test_elastic_reshard_multidevice``): saved on
  a 4-rank data mesh, restored onto (2, 2) ``P('data', 'model')`` and (4,
  1), in both directions across the packages.
- The publisher with a mesh (frames byte-identical without one and to the
  reference's), the preemption save of a sharded state, the async
  checkpointer and the Supervisor's restore onto another mesh.
- The launchers' dense step in gloo worlds under ``torchrun``.
"""
import os
import subprocess
import sys

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
from repro.runtime import delta_sync as JR
from repro.train import TrainHParams as RefHP
from repro.train import make_train_step as ref_make_train_step
from repro_torch.launch.world import spawn_world
from repro_torch.optim import cosine_schedule
from repro_torch.train import TrainHParams
from test_torch_train_step import (RTOL_METRIC, assert_leaves_close,
                                   ref_params)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))
WORLD_TIMEOUT_S = 240
CASES = sorted(k for k in W.SHARDED_CASES if k != "one")


@pytest.fixture(scope="module")
def params_np():
    return jax.tree.map(np.asarray, ref_params(W.TRAIN_ARCH))


@pytest.fixture(scope="module")
def sharded(params_np):
    """``{case: [each rank's results]}`` over worlds of 1, 2 and 4, and
    the world of two's compressed-step bytes."""
    by_arch = {W.TRAIN_ARCH: params_np,
               W.MOE_ARCH: jax.tree.map(np.asarray, ref_params(W.MOE_ARCH))}
    out, extra = {}, {}
    for world in (1, 2, 4):
        res = spawn_world(W.sharded_step_rank, world, by_arch,
                          timeout=WORLD_TIMEOUT_S)
        for name in W.sharded_cases(world):
            out[name] = [r[name] for r in res]
        if world == 2:
            extra["compressed_bytes"] = [r["compressed_bytes"] for r in res]
    return out, extra


def ref_steps(case: str):
    """The reference's unsharded step on ``case``'s model and batch:
    params, moments and metrics after each of :data:`W.SHARDED_STEPS`
    steps."""
    _, rows, grad_accum = W.SHARDED_CASES[case]
    arch, cfg = W.case_config(case, ref_smoke)
    rm = ref_build_model(cfg)
    step = jax.jit(ref_make_train_step(rm, RefHP(**W.TRAIN_HP,
                                                 grad_accum=grad_accum)))
    p = ref_params(arch)
    o = ref_adamw_init(p)
    mets = []
    for s in range(W.SHARDED_STEPS):
        b = {k: jnp.asarray(v[:rows]) for k, v in W.train_batch(s).items()}
        p, o, met = step(p, o, b)
        mets.append({k: float(v) for k, v in met.items()})
    return (jax.tree.leaves(p), jax.tree.leaves(o.mu),
            jax.tree.leaves(o.nu), mets)


def lr_sum() -> float:
    hp = W.TRAIN_HP
    return sum(float(cosine_schedule(
        torch.tensor(s), peak_lr=TrainHParams().peak_lr, warmup=hp["warmup"],
        total=hp["total_steps"])) for s in range(W.SHARDED_STEPS))


@pytest.mark.parametrize("case", CASES)
def test_sharded_step_matches_reference(sharded, case):
    """Within the plain step's tolerances of the reference's unsharded
    step; for a MoE, with its capacity and load statistics over the whole
    batch (in the ``cap1`` cases the capacity binds and drops)."""
    rp, rmu, rnu, rmets = ref_steps(case)
    if W.MOE_CAPACITY.get(case):
        assert sum(res["dropped"] for res in sharded[0][case]) > 0
    for rank, res in enumerate(sharded[0][case]):
        what = f"{case} rank {rank}"
        assert_leaves_close(rp, res["params"], what=what + " params",
                            lr_sum=lr_sum())
        assert_leaves_close(rmu, res["mu"], what=what + " mu")
        assert_leaves_close(rnu, res["nu"], what=what + " nu")
        for s, (want, got) in enumerate(zip(rmets, res["metrics"])):
            for k in ("loss", "grad_norm", "lr"):
                assert abs(got[k] - want[k]) <= RTOL_METRIC * abs(want[k]), \
                    (what, s, k)


@pytest.mark.parametrize("case", CASES)
def test_grad_norm_and_params_are_bit_identical_on_every_rank(sharded, case):
    ranks = sharded[0][case]
    for res in ranks[1:]:
        for a, b in zip(ranks[0]["metrics"], res["metrics"]):
            assert a["grad_norm_bits"] == b["grad_norm_bits"]
            assert a["loss"] == b["loss"]
        for a, b in zip(ranks[0]["params"], res["params"]):
            assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("case", CASES + ["one"])
def test_moments_take_the_params_placements(sharded, case):
    assert all(res["moments_placed"] for res in sharded[0][case])


def test_batch_rows_split_over_data_or_replicate(sharded):
    """Rows split over the data dim when it divides the batch; a batch of
    3 on data = 2 is replicated and split over no dim (no mean)."""
    res = sharded[0]
    assert [r["split"] for r in res["dp2"]] == [(0,), (0,)]
    assert [r["local_rows"] for r in res["dp2"]] == [4, 4]
    assert [r["split"] for r in res["dp2xtp2"]] == [(0,)] * 4
    assert [r["local_rows"] for r in res["dp2xtp2"]] == [4] * 4
    assert [r["split"] for r in res["tp2"]] == [(), ()]
    assert [r["split"] for r in res["dp2_b3"]] == [(), ()]
    assert [r["local_rows"] for r in res["dp2_b3"]] == [3, 3]
    assert [r["split"] for r in res["moe_cap1_dp2xtp2_accum2"]] == [(0,)] * 4


def test_world_of_one_is_bitwise_the_plain_step(sharded):
    (res,) = sharded[0]["one"]
    plain = res["plain"]
    for kind in ("params", "mu", "nu"):
        for a, b in zip(res[kind], plain[kind]):
            assert a.tobytes() == b.tobytes(), kind
    for a, b in zip(res["metrics"], plain["metrics"]):
        assert a == b


def test_world_of_one_moe_is_bitwise_the_plain_step(sharded):
    """At world 1 the MoE keeps its whole buffer and the plain step's
    bits, with assignments dropped."""
    (res,) = sharded[0]["moe_cap1_one"]
    plain = res["plain"]
    assert res["dropped"] == plain["dropped"] > 0
    for kind in ("params", "mu", "nu"):
        for a, b in zip(res[kind], plain[kind]):
            assert a.tobytes() == b.tobytes(), kind
    for a, b in zip(res["metrics"], plain["metrics"]):
        assert a == b


def param_collective_bytes(params_np) -> dict:
    """The bytes one dense step on (2, 2) hands its collectives on
    parameters, a rank, from the specs: each use's gather of its leaf's
    local shard (a layer's leaves twice, in the forward and in the
    checkpoint's recompute; none for a replicated leaf), each use's
    reduction of its f32 gradient (the leaf's whole layer, half of it for
    the leaves the blocks keep on their ``model`` shards: the vocabulary
    and the MLP; the smoke config's 3 heads do not split over 2), and the
    loss's mean."""
    from repro_torch import tree as TR
    from repro_torch.sharding.api import MeshShape, spec_placements
    from repro_torch.sharding.params import params_shardings

    mesh = MeshShape(("data", "model"), (2, 2))
    leaves, names, treedef = TR.flatten_with_names(params_np)
    specs = TR.flatten_up_to(treedef, params_shardings(params_np, mesh))
    kept = {"embed", "head", "w1", "w3", "w2"}
    out = {"gather": 0, "reduce": 4}
    for leaf, name, sh in zip(leaves, names, specs):
        stacked = leaf.shape[0] if name.startswith("['layers']") else 1
        whole = leaf.size // stacked * 4
        n_shard = sum(p.is_shard() for p in spec_placements(sh.spec, mesh))
        if n_shard:
            out["gather"] += (stacked * (2 if stacked > 1 else 1)
                              * whole // 2 ** n_shard)
        out["reduce"] += stacked * (whole // 2 if name.split("'")[-2]
                                    in kept else whole)
    return out


def test_collective_bytes_of_a_dense_and_a_compressed_step(sharded,
                                                           params_np):
    """The bytes one step hands to its collectives on parameters on (2,
    2) (f32 here: the smoke config computes in f32), exactly as
    :func:`param_collective_bytes` works them out; beside them the bytes
    one compressed step (k 0.05) lands in a rank's receive buffers on two
    ranks. Printed (``-s``) for PERF.md."""
    n = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(params_np))
    want = param_collective_bytes(params_np)
    assert (want["gather"], want["reduce"]) == (92_160, 129_988)
    dense = [r["bytes"] for r in sharded[0]["dp2xtp2"]]
    for b in dense:
        assert b == want
    comp = sharded[1]["compressed_bytes"]
    assert all(0 < c < 4 * n for c in comp)
    print(f"\nsmoke {W.TRAIN_ARCH}: {n} params; dense step on (2, 2), per "
          f"rank: gather operands {[b['gather'] for b in dense]} B, "
          f"reduce operands {dense[0]['reduce']} B; compressed step "
          f"(k {W.TRAIN_K}) on 2 ranks, received {comp} B")


# ---------------------------------------------------------------------------
# elastic checkpoints, both directions across the packages
# ---------------------------------------------------------------------------

REF_ELASTIC_SAVE = r"""
import jax, jax.numpy as jnp, numpy as np, sys
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.checkpoint import save_checkpoint
sys.path.insert(0, {tests!r})
import _torch_world as W
mesh = jax.make_mesh((4,), ('data',))
x = jax.device_put(jnp.asarray(W.elastic_array()),
                   NamedSharding(mesh, P('data')))
save_checkpoint({path!r}, 1, {{'x': x}})
print('ok')
"""

REF_ELASTIC_RESTORE = r"""
import jax, jax.numpy as jnp, numpy as np, sys
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.checkpoint import restore_checkpoint
sys.path.insert(0, {tests!r})
import _torch_world as W
x = W.elastic_array()
for shape, spec in W.ELASTIC_RESTORES.values():
    mesh = jax.make_mesh(shape, ('data', 'model'))
    sh = {{'x': NamedSharding(mesh, P(*spec))}}
    out = restore_checkpoint({path!r}, 1, {{'x': x}}, sh)
    np.testing.assert_array_equal(np.asarray(out['x']), x)
    assert out['x'].sharding.spec == P(*spec)
    for dev, idx in out['x'].sharding.devices_indices_map(x.shape).items():
        shard = [s for s in out['x'].addressable_shards
                 if s.device == dev][0]
        np.testing.assert_array_equal(np.asarray(shard.data), x[idx])
print('ok')
"""


@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    root = tmp_path_factory.mktemp("elastic")
    port_dir, ref_dir = str(root / "port"), str(root / "reference")
    run_multidevice(REF_ELASTIC_SAVE.format(tests=TESTS, path=ref_dir),
                    n_devices=4)
    res = spawn_world(W.elastic_rank, 4, port_dir, ref_dir,
                      timeout=WORLD_TIMEOUT_S)
    return res, port_dir


@pytest.mark.parametrize("layout", sorted(W.ELASTIC_RESTORES))
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_elastic_restore_onto_another_mesh(elastic, writer, layout):
    res, _ = elastic
    x = W.elastic_array()
    shape, _ = W.ELASTIC_RESTORES[layout]
    for rank, r in enumerate(res):
        got = r[f"{writer}/{layout}"]
        d, t = np.unravel_index(rank, shape)
        rows, cols = x.shape[0] // shape[0], x.shape[1] // shape[1]
        want = x[d * rows:(d + 1) * rows, t * cols:(t + 1) * cols]
        np.testing.assert_array_equal(got["local"], want)
        np.testing.assert_array_equal(got["whole"], x)
        assert got["placements"] == ["Shard(dim=0)", "Shard(dim=1)"]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_elastic_restore_onto_plain_tensors(elastic, writer):
    res, _ = elastic
    for r in res:
        kind, arr = r[f"{writer}/plain"]
        assert kind == "Tensor"
        np.testing.assert_array_equal(arr, W.elastic_array())


def test_sharded_save_copies_to_the_host_on_rank_zero_only(elastic):
    res, _ = elastic
    assert [r["host_copies"] for r in res] == [1, 0, 0, 0]


@pytest.mark.parametrize("case", sorted(W.REGION_CASES))
def test_restore_region_is_the_local_shard(elastic, case):
    """The slice of the file a rank reads on restore is the shard DTensor
    places on it, nested and uneven shards too."""
    res, _ = elastic
    assert all(r["regions"][case] for r in res)


def test_reference_restores_the_ports_sharded_save(elastic):
    _, port_dir = elastic
    run_multidevice(REF_ELASTIC_RESTORE.format(tests=TESTS, path=port_dir),
                    n_devices=4)


# ---------------------------------------------------------------------------
# the publisher's mesh, the preemption save, async saves, the supervisor
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runtime(params_np, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sharded_runtime"))
    return spawn_world(W.sharded_runtime_rank, 2, params_np, root,
                       timeout=WORLD_TIMEOUT_S)


def test_publisher_frames_with_a_mesh_are_byte_identical(runtime, params_np):
    wire = JR.InProcTransport()
    pub = JR.DeltaPublisher(jax.tree.map(jnp.asarray, params_np), wire,
                            k_fraction=0.05, selector="block")
    for epoch in (1, 2):
        pub.publish(jax.tree.map(jnp.asarray,
                                 W.publish_params(params_np, epoch)))
    ref_frames = wire.poll()
    assert len(ref_frames) == 2 * len(jax.tree.leaves(params_np))
    for res in runtime:
        for name in ("none", "2x1", "1x2"):
            assert res["frames"][name] == ref_frames, name


def test_publisher_places_residuals_by_ef_shardings(runtime):
    """(1, size) residuals: the data axis drops on data = 2 and stays on
    data = 1; the size dim is never split."""
    for res in runtime:
        assert res["ef_placements/none"] is None
        assert res["ef_placements/2x1"] == ["(Replicate(), Replicate())"]
        assert res["ef_placements/1x2"] == ["(Shard(dim=0), Replicate())"]


def test_preemption_save_of_a_sharded_state_writes_nothing(runtime):
    for res in runtime:
        assert res["preempt_sharded"] is None
        assert res["preempt_sharded_wrote"] is None
        assert res["preempt_plain"].endswith("step_00000004")
        assert res["preempt_plain_wrote"] == 4


def test_async_save_of_a_sharded_state(runtime):
    for res in runtime:
        assert res["async_steps"] == 5 and res["async_equal"]


def test_supervisor_resumes_onto_another_mesh(runtime, params_np):
    want = [x + np.float32(1) + np.float32(1) + np.float32(1)
            + np.float32(1) for x in jax.tree.leaves(params_np)]
    for res in runtime:
        assert res["supervisor_steps"] == 4
        assert all(a == b for a, b in res["supervisor_placements"])
        for a, b in zip(res["supervisor_values"], want):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the launchers' dense step in gloo worlds
# ---------------------------------------------------------------------------

def torchrun(nproc, args, timeout=400):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               PYTHONHASHSEED="0", OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(nproc), "-m", *args], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, f"{args}\n{proc.stdout}\n{proc.stderr}"
    return proc.stdout


SMOKE = ["--arch", "smollm-135m", "--smoke", "--device", "cpu"]


def test_train_launcher_dense_resumes_on_another_mesh(tmp_path):
    """Four ranks on 2 x 2 save global checkpoints in one directory; two
    ranks on 1 x 2 resume from them, then two on 2 x 1 (the elastic path
    end to end)."""
    ckpt = str(tmp_path)
    out = torchrun(4, ["repro_torch.launch.train", *SMOKE, "--steps", "4",
                       "--ckpt-every", "2", "--mesh", "2x2",
                       "--ckpt-dir", ckpt])
    assert "mesh: {'data': 2, 'model': 2} over 4 ranks (cpu)" in out
    assert "finished at step 4" in out
    assert sorted(os.listdir(ckpt)) == ["step_00000002", "step_00000004"]
    out = torchrun(2, ["repro_torch.launch.train", *SMOKE, "--steps", "6",
                       "--ckpt-every", "2", "--mesh", "1x2",
                       "--ckpt-dir", ckpt])
    assert "finished at step 6; restarts=0" in out
    assert "step     0 loss" not in out  # resumed, not restarted
    assert sorted(os.listdir(ckpt))[-1] == "step_00000006"
    out = torchrun(2, ["repro_torch.launch.train", *SMOKE, "--steps", "8",
                       "--ckpt-every", "2", "--mesh", "2x1",
                       "--ckpt-dir", ckpt])
    assert "mesh: {'data': 2, 'model': 1} over 2 ranks (cpu)" in out
    assert "finished at step 8; restarts=0" in out
    assert "step     0 loss" not in out
    assert sorted(os.listdir(ckpt))[-1] == "step_00000008"


def test_train_100m_dense_in_a_gloo_world(tmp_path):
    out = torchrun(2, ["repro_torch.launch.train_100m", "--steps", "1",
                       "--batch", "2", "--seq", "32", "--ckpt-dir",
                       str(tmp_path / "ckpt"), "--device", "cpu"])
    assert "model: repro-100m, 124.7M params" in out
    assert "done: 1 steps" in out
    assert os.listdir(tmp_path / "ckpt") == ["step_00000001"]
