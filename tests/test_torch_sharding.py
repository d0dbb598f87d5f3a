"""The port's sharding (``repro_torch.sharding``, ``launch/mesh.py``)
against the reference's (``repro.sharding``), on the CPU.

- Spec parity: the reference runs in one subprocess of 512 placeholder
  devices (``tests/conftest.py``'s ``run_multidevice``) and emits, as JSON,
  the spec of every leaf of the ten configs' full-size params trees
  (``jax.eval_shape``), of their AdamW state, of ``input_specs`` batches,
  of ``decode_inputs`` caches and of the error-feedback layouts, on the
  16 x 16, 2 x 16 x 16 and (4, 2) meshes. The port works out the same
  specs from the mesh's names and sizes alone (``MeshShape``), on trees of
  fake tensors (no values drawn), and each must equal the reference's.
- Every assertion of ``tests/test_sharding.py``, replayed on the port, one
  case a test.
- Placement: in a gloo world of four ranks, each rank's local shard under
  a (2, 2) ``("data", "model")`` mesh and under a (2, 2, 1) ``("pod",
  "data", "model")`` mesh (``("pod", "data")`` nested on one dim) equals
  the slice JAX puts on that device (``devices_indices_map``).
"""
import json
import os

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import _torch_world as W
from _torch_parity import tree_leaves
from conftest import run_multidevice
from repro_torch import tree as TR
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.topk import global_k, per_shard_k
from repro_torch.data import decode_inputs, input_specs
from repro_torch.launch.mesh import chips, production_mesh_shape
from repro_torch.launch.world import spawn_world
from repro_torch.models import build_model
from repro_torch.models.common import SHAPES
from repro_torch.optim import adamw_init
from repro_torch.sharding import (RULES, get_mesh, logical_to_physical,
                                  mesh_context)
from repro_torch.sharding.api import (MeshShape, NamedSharding, P,
                                      named_sharding, shard,
                                      spec_placements)
from repro_torch.sharding.params import (batch_spec, cache_shardings,
                                         cache_spec, ef_shardings, ef_spec,
                                         param_spec, params_shardings)
from repro_torch.train import init_ef_state

MESHES = {"16x16": production_mesh_shape(),
          "2x16x16": production_mesh_shape(multi_pod=True),
          "4x2": MeshShape(("data", "model"), (4, 2))}
KINDS = ("params", "opt", "batch", "cache", "ef")
WORLD_TIMEOUT_S = 200

REF_SPECS = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import ARCHS, get_config
from repro.data import decode_inputs, input_specs
from repro.launch.mesh import make_production_mesh
from repro.models import build_model
from repro.models.common import SHAPES
from repro.optim import adamw_init
from repro.sharding.params import (batch_spec, cache_spec, ef_spec,
                                   params_shardings)
from repro.train import init_ef_state

sys.path.insert(0, {tests!r})
import _torch_world as W
from _torch_parity import tree_leaves

def js(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]

def keyed(tree, fn):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [[jax.tree_util.keystr(p), fn(p, x)] for p, x in flat]

meshes = {{"16x16": make_production_mesh(),
          "2x16x16": make_production_mesh(multi_pod=True),
          "4x2": Mesh(np.array(jax.devices()[:8]).reshape(4, 2),
                      ("data", "model"))}}
out = {{}}
for arch in ARCHS:
    cfg = get_config(arch)
    model = build_model(cfg)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    opt = jax.eval_shape(adamw_init, params)
    for mname, mesh in meshes.items():
        key = f"{{arch}}/{{mname}}"
        sh = params_shardings(params, mesh)
        out[key + "/params"] = [[n, js(s.spec)] for n, s in keyed(
            sh, lambda p, s: s)]
        out[key + "/opt"] = [js(s.spec) for s in jax.tree.leaves(
            params_shardings(opt, mesh))]
        batch, cache = {{}}, {{}}
        for sname, shape in SHAPES.items():
            batch[sname] = {{k: js(batch_spec(v, mesh))
                            for k, v in input_specs(cfg, shape).items()}}
            caches, _ = decode_inputs(cfg, shape, model)
            cache[sname] = [js(cache_spec(x, cfg, mesh, shape.global_batch))
                            for x in jax.tree.leaves(caches)]
        out[key + "/batch"] = batch
        out[key + "/cache"] = cache
        d = mesh.shape["data"]
        t = mesh.shape.get("model", 1)
        ef = {{}}
        for lay, shards in (("dp", 1), ("dp_tp", t)):
            e = jax.eval_shape(lambda p: init_ef_state(p, d,
                                                       model_shards=shards),
                               params)
            ef[lay] = [js(ef_spec(x, mesh)) for x in jax.tree.leaves(e)]
        out[key + "/ef"] = ef

# the placement slices: each leaf of W.placement_tree() on each of
# W.PLACEMENT_MESHES over the first four devices, device r at mesh
# position r
tree = W.placement_tree()
for mname, (axes, shape) in W.PLACEMENT_MESHES.items():
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(shape), axes)
    shs = params_shardings(tree, mesh)
    slices = {{}}
    for (path, leaf), sh in zip(
            jax.tree_util.tree_flatten_with_path(tree)[0],
            jax.tree.leaves(shs)):
        dmap = sh.devices_indices_map(leaf.shape)
        slices[jax.tree_util.keystr(path)] = [
            [[s.start or 0, leaf.shape[i] if s.stop is None else s.stop]
             for i, s in enumerate(dmap[dev])]
            for dev in mesh.devices.reshape(-1)]
    out["placement/" + mname] = slices
with open({path!r}, "w") as f:
    json.dump(out, f)
print("ok")
"""


def js(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref_specs") / "specs.json")
    tests = os.path.dirname(os.path.abspath(__file__))
    run_multidevice(REF_SPECS.format(tests=tests, path=path),
                    n_devices=512, timeout=900)
    with open(path) as f:
        return json.load(f)


def fake_params(arch):
    """The arch's full-size params tree as fake tensors (shapes and
    dtypes, no storage) and its model."""
    model = build_model(get_config(arch))
    with FakeTensorMode():
        return model.init(0, device="cpu"), model


def port_specs(arch, mname, kind):
    """What the port gives for the reference's ``<arch>/<mesh>/<kind>``,
    on fake tensors (one fake mode for the whole tree)."""
    mesh = MESHES[mname]
    cfg = get_config(arch)
    model = build_model(cfg)
    with FakeTensorMode():
        params = model.init(0, device="cpu")
        if kind == "params":
            leaves, names, _ = TR.flatten_with_names(params)
            return [[n, js(param_spec(n, x, mesh))]
                    for n, x in zip(names, leaves)]
        if kind == "opt":
            opt = tuple(adamw_init(params))
            return [js(s.spec) for s in TR.flatten_up_to(
                TR.flatten(opt)[1], params_shardings(opt, mesh))]
        if kind == "ef":
            sizes = dict(zip(mesh.axis_names, mesh.shape))
            out = {}
            for lay, shards in (("dp", 1), ("dp_tp", sizes.get("model", 1))):
                ef = init_ef_state(params, sizes["data"], model_shards=shards)
                out[lay] = [js(ef_spec(x, mesh)) for x in TR.leaves(ef)]
            return out
    if kind == "batch":
        return {s: {k: js(batch_spec(v, mesh))
                    for k, v in input_specs(cfg, shape).items()}
                for s, shape in SHAPES.items()}
    assert kind == "cache"
    out = {}
    for s, shape in SHAPES.items():
        caches, _ = decode_inputs(cfg, shape, model)
        out[s] = [js(sh.spec) for sh in tree_leaves(
            cache_shardings(caches, cfg, mesh, shape.global_batch))]
    return out


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_reference(ref, arch, mesh, kind):
    want = ref[f"{arch}/{mesh}/{kind}"]
    got = port_specs(arch, mesh, kind)
    assert got == want


def test_fake_params_cost_no_storage():
    """The full-size trees above are fake: Llama4-Scout's 101.7 G
    parameters draw nothing."""
    params, _ = fake_params("llama4-scout-17b-a16e")
    assert sum(x.numel() for x in TR.leaves(params)) > 10**11


# ---------------------------------------------------------------------------
# tests/test_sharding.py, replayed on the port
# ---------------------------------------------------------------------------

PROD, POD = MESHES["16x16"], MESHES["2x16x16"]
MESH_4X2 = MESHES["4x2"]


def spec_of(name, shape, mesh=PROD):
    return param_spec((name,), torch.empty(shape, device="meta"), mesh)


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


PARAM_CASES = {
    # 2D weights: fsdp x tp
    "wq": (("wq", (4096, 4096)), P("data", "model")),
    "wo": (("wo", (4096, 4096)), P("model", "data")),
    "embed": (("embed", (262144, 5376)), P("model", "data")),
    # stacked layer dims pad with None
    "w1_stacked": (("w1", (48, 4096, 16384)), P(None, "data", "model")),
    # non-divisible axes are dropped, not errors
    "wq_odd": (("wq", (4095, 4096)), P(None, "model")),
    # norms replicated
    "ln1": (("ln1", (4096,)), P(None)),
    # MoE experts on model
    "we1": (("we1", (48, 64, 2048, 1408)), P(None, "model", "data", None)),
}


@pytest.mark.parametrize("case", sorted(PARAM_CASES))
def test_param_specs_fsdp_tp(case):
    (name, shape), want = PARAM_CASES[case]
    assert spec_of(name, shape) == want


BATCH_CASES = {
    # batch: leading dim on (pod+)data
    "tokens": ((256, 4096), PROD, P("data", None)),
    # mrope positions: (3, B, S)
    "mrope": ((3, 256, 4096), PROD, P(None, "data", None)),
    # batch=1 replicates instead of failing
    "batch1": ((1, 524288), PROD, P(None, None)),
    "multipod": ((256, 4096), POD, P(("pod", "data"), None)),
}


@pytest.mark.parametrize("case", sorted(BATCH_CASES))
def test_batch_specs(case):
    shape, mesh, want = BATCH_CASES[case]
    assert batch_spec(meta(*shape, dtype=torch.int32), mesh) == want


CACHE_CASES = {
    # kv=8 (non-divisible), head_dim=128: the head_dim fallback
    "qwen2_vl_kv": ("qwen2_vl_72b", (80, 128, 32768, 8, 128),
                    P(None, "data", None, None, "model")),
    # kv=16 divisible
    "gemma3_kv": ("gemma3_27b", (10, 128, 32768, 16, 128),
                  P(None, "data", None, "model", None)),
    "mamba2_ssm": ("mamba2_370m", (48, 128, 32, 64, 128),
                   P(None, "data", "model", None, None)),
}


@pytest.mark.parametrize("case", sorted(CACHE_CASES))
def test_cache_specs(case):
    arch, shape, want = CACHE_CASES[case]
    leaf = meta(*shape, dtype=torch.bfloat16)
    assert cache_spec(leaf, get_config(arch), PROD, batch=128) == want


def test_multipod_dp_axes():
    s = spec_of("wq", (8192, 8192), POD)
    assert s == P(("pod", "data"), "model")  # fsdp composes with pod


EF_CASES = {
    # DP-only layout (P, size): worker dim over data
    "dp": ((4, 1000), P("data", None)),
    # DP x TP layout (D, T, shard_len): (worker, model shard) over both
    "dp_tp": ((4, 2, 500), P("data", "model", None)),
    # non-divisible dims drop their axis instead of failing
    "odd": ((3, 1000), P(None, None)),
}


@pytest.mark.parametrize("case", sorted(EF_CASES))
def test_ef_specs_dp_and_2d(case):
    shape, want = EF_CASES[case]
    assert ef_spec(meta(*shape), MESH_4X2) == want


def test_ef_shardings_of_init_ef_state():
    params = {"w": torch.zeros(7, 3), "b": torch.zeros(5)}
    ef = init_ef_state(params, 4, model_shards=2)
    assert ef["w"].shape == (4, 2, 11)   # ceil(21/2)
    assert ef["b"].shape == (4, 2, 3)    # ceil(5/2)
    assert ef_shardings(ef, MESH_4X2)["w"].spec == P("data", "model", None)
    ef1 = init_ef_state(params, 4)
    assert ef1["w"].shape == (4, 21)
    assert ef_shardings(ef1, MESH_4X2)["w"].spec == P("data", None)


@pytest.mark.parametrize("n,frac,t", [(100_000, 0.01, 4), (16384, 0.05, 2),
                                      (999, 1.0, 4), (65536, 0.001, 8)])
def test_per_shard_k_budget(n, frac, t):
    k = global_k(n, frac)
    ks = per_shard_k(n, frac, t)
    assert k <= ks * t <= k + t - 1


def test_per_shard_k_edges():
    assert per_shard_k(10, 1.0, 4) == 3   # == ceil(10/4) == shard length
    assert per_shard_k(8, 1.0, 2) == 4
    assert per_shard_k(100, 1e-6, 8) == 1
    assert per_shard_k(1000, 0.01, 1) == global_k(1000, 0.01)


# ---------------------------------------------------------------------------
# the port's own API: specs to placements, the mesh context
# ---------------------------------------------------------------------------

def test_spec_placements():
    from torch.distributed.tensor import Replicate, Shard

    assert spec_placements(P("data", "model"), PROD) == (Shard(0), Shard(1))
    assert spec_placements(P("model", None), PROD) == (Replicate(),
                                                       Shard(0))
    assert spec_placements(P(("pod", "data"), "model"), POD) == (
        Shard(0), Shard(0), Shard(1))
    assert spec_placements(P(), POD) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh-dim order"):
        spec_placements(P(("data", "pod"), None), POD)
    with pytest.raises(ValueError, match="twice"):
        spec_placements(P("data", "data"), PROD)
    with pytest.raises(ValueError, match="not an axis"):
        spec_placements(P("pod"), PROD)


def test_logical_rules_and_mesh_context():
    assert get_mesh() is None
    assert named_sharding("batch", "seq") is None
    x = torch.ones(2, 3)
    assert shard(x, "batch", "d_model") is x  # no mesh: a no-op
    with mesh_context(PROD):
        assert logical_to_physical("batch", "seq", "heads") == P(
            "data", None, "model")
        sh = named_sharding("vocab", "d_model")
        assert sh == NamedSharding(PROD, P("model", None))
        assert shard(x, "batch", "d_model") is x  # a plain tensor
        with mesh_context(POD):
            assert logical_to_physical("fsdp", "dff") == P(
                ("pod", "data"), "model")
            assert logical_to_physical("capacity") == P("data")
        assert get_mesh() is PROD
    assert get_mesh() is None
    assert RULES["experts"] == "model" and RULES["seq"] is None


def test_mesh_shapes_and_chips():
    assert chips(PROD) == 256 and chips(POD) == 512
    assert PROD.axis_names == ("data", "model")
    assert POD.axis_names == ("pod", "data", "model")


# ---------------------------------------------------------------------------
# placement in a gloo world of four
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def placed():
    return spawn_world(W.placement_rank, 4, timeout=WORLD_TIMEOUT_S)


@pytest.mark.parametrize("mesh", sorted(W.PLACEMENT_MESHES))
def test_local_shards_are_the_slices_jax_places(ref, placed, mesh):
    tree = W.placement_tree()
    leaves, names, _ = TR.flatten_with_names(tree)
    slices = ref["placement/" + mesh]
    shape = W.PLACEMENT_MESHES[mesh][1]
    for rank, res in enumerate(placed):
        got = res[mesh]
        assert got["coord"] == tuple(np.unravel_index(rank, shape))
        assert got["whole"]
        for name, x in zip(names, leaves):
            want = x[tuple(slice(a, b) for a, b in slices[name][rank])]
            np.testing.assert_array_equal(got["local"][name], want,
                                          err_msg=f"{mesh} {name} {rank}")


def test_nested_pod_data_shards_one_dim(placed):
    """("pod", "data") on one dim: four row blocks, pod major."""
    blocks = [res["pod2x2x1"]["local"]["['embed']"] for res in placed]
    # embed is (vocab, d) -> ("model", ("pod", "data")): d split in four
    full = W.placement_tree()["embed"]
    np.testing.assert_array_equal(np.concatenate(blocks, axis=1), full)


def test_shard_memory_counts_a_ranks_share():
    """``launch/shard_memory.py``: a rank holds a leaf over the product of
    the mesh axes its spec names; a replicated leaf whole."""
    from repro_torch.launch.shard_memory import per_rank_elements

    tree = {"wq": meta(32, 64), "ln1": meta(64), "we1": meta(2, 16, 32, 8)}
    # wq over data x model, ln1 whole, we1 over model (experts) x data;
    # on the pod mesh data is ("pod", "data"), 32 ranks
    for mesh, ranks in ((PROD, 256), (POD, 512)):
        want = 32 * 64 // ranks + 64 + 2 * 16 * 32 * 8 // ranks
        assert per_rank_elements(tree, mesh) == want
