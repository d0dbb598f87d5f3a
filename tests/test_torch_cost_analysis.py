"""The port's cost analysis (``repro_torch.launch.hlo_analysis``) against
the reference's, on the CPU.

- FLOPs: the smoke config of ``smollm-135m``, one dense train step on one
  device. The port counts the matrix products its eager step dispatches
  (``FlopCounterMode``); the reference's are the dot FLOPs of its compiled
  step (``jit(step).lower(...).compile()`` on one CPU device), the summed
  ``_dot_flops`` of every ``dot`` instruction with while-loop trip counts
  applied (its ``ModuleAnalyzer`` walk, without the elementwise term).
  They agree within 2 %. The gap is one product: ``torch.utils.checkpoint``
  recomputes each attention chunk's whole step in the backward, its P·V
  product too, whose value no gradient needs; XLA drops that dead product
  from its rematerialized forward (2 layers × 2 key chunks × 2·B·S·Hq·D·C
  FLOPs, the whole gap).
- Collectives: one smoke step on a (2, 2) gloo world, worked out from the
  leaves' specs and the activations' shapes. Each layer gathers its
  leaves where it uses them (twice: the forward and the checkpoint's
  recompute), the embedding, ``head`` and the MLP on their ``model``
  shards (gathered over ``data`` only; the smoke config's 3 heads do not
  split over 2 ranks, so the attention's weights are gathered whole, one
  all-gather a sharded mesh dim: DTensor gathers one mesh dim at a time),
  and each use's gradient is reduced into its leaf's shard as its
  backward ends: 141,360 B in 47 all-gathers (the grad norm's table of
  partial sums, 4 B a leaf, among them), 129,024 B in 16
  reduce-scatters, and 150,980 B in 22 all-reduces: the replicated
  norms' gradients, the loss, and the sums over ``model`` of the
  activations (the lookup's, each split MLP's in forward and of its
  input's gradient in backward, the loss's input gradient, and each CE
  chunk's max, sum of ``exp`` and gold logit; the checkpoint's recompute
  stops at the last product whose inputs backward needs, so it repeats
  no sum after that).
- Fake and real CPU tensors give the same counts, to the byte.
"""
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_world as W
from repro.configs import get_smoke_config as ref_smoke
from repro.launch import hlo_analysis as H
from repro.models import build_model as ref_build_model
from repro.optim import adamw_init as ref_adamw_init
from repro.train import TrainHParams as RefHP
from repro.train import make_train_step as ref_make_train_step
from repro_torch import interop
from repro_torch import tree as TR
from repro_torch.compat import fake_tensor_mode
from repro_torch.configs import get_smoke_config
from repro_torch.launch import hlo_analysis as PH
from repro_torch.launch.world import spawn_world
from repro_torch.models import build_model
from repro_torch.optim import adamw_init
from repro_torch.sharding.api import MeshShape, spec_placements
from repro_torch.sharding.params import params_shardings
from repro_torch.train import TrainHParams, make_train_step
from test_torch_train_step import ref_params

WORLD_TIMEOUT_S = 200
#: The share the port's product FLOPs may differ from the reference's dots.
FLOPS_RTOL = 0.02


def ref_dot_flops(hlo_text: str) -> float:
    """The summed ``_dot_flops`` of every dot of a compiled module, each
    while body times its known trip count (``ModuleAnalyzer``'s walk,
    counting dots only)."""
    comps = H.parse_module(hlo_text)

    def walk(name):
        comp = comps.get(name)
        if comp is None:
            return 0.0
        total = 0.0
        for ins in comp.instrs:
            if ins.opcode == "while":
                mt = H._TRIP_RE.search(ins.rest)
                trips = int(mt.group(1)) if mt else 1
                for c in re.findall(r"(?:body|condition)=%?([\w\.\-]+)",
                                    ins.rest):
                    total += trips * walk(c)
            elif ins.opcode == "dot" or ins.opcode.startswith("dot."):
                total += H._dot_flops(ins, comp)
            else:
                for c in re.findall(r"(?:calls|to_apply|branch_computations="
                                    r"\{?)%?([\w\.\-]+)", ins.rest):
                    total += walk(c)
        return total

    return walk(re.search(r"^ENTRY\s+%?([\w\.\-]+)", hlo_text, re.M).group(1))


@pytest.fixture(scope="module")
def params_np():
    return jax.tree.map(np.asarray, ref_params(W.TRAIN_ARCH))


def batch_np():
    return W.train_batch(0)


def test_flops_of_the_smoke_step_against_the_reference_dots(params_np):
    cfg = ref_smoke(W.TRAIN_ARCH)
    rmodel = ref_build_model(cfg)
    rp = jax.tree.map(jnp.asarray, params_np)
    compiled = jax.jit(ref_make_train_step(rmodel, RefHP(**W.TRAIN_HP))) \
        .lower(rp, ref_adamw_init(rp),
               {k: jnp.asarray(v) for k, v in batch_np().items()}).compile()
    ref = ref_dot_flops(compiled.as_text())

    model = build_model(get_smoke_config(W.TRAIN_ARCH))
    p = interop.params_from_numpy(params_np, "cpu")
    _, roof = PH.analyze_step(
        make_train_step(model, TrainHParams(**W.TRAIN_HP)), p, adamw_init(p),
        {k: torch.from_numpy(v) for k, v in batch_np().items()})
    assert abs(roof.flops - ref) <= FLOPS_RTOL * ref, (roof.flops, ref)
    # the gap: one P·V product a key chunk a layer, recomputed by the port
    B, S = W.TRAIN_BATCH
    chunk = W.TRAIN_HP["attn_chunk"]
    pv = 2 * B * S * cfg.n_heads * cfg.head_dim * chunk
    assert roof.flops - ref == cfg.n_layers * (S // chunk) * pv
    assert roof.xla_flops_once is None
    assert roof.coll_bytes == 0 and roof.coll_counts == {}


def test_counts_of_a_small_function():
    """Products at 2·M·N·K; every materialising op's operands and result;
    views free; arguments, results and the step's own peak from storage."""
    a, b = torch.randn(64, 32), torch.randn(32, 16)

    def f(a, b):
        c = a @ b              # 64·16·4 B out, 2·64·32·16 FLOPs
        d = c.t()              # a view: free
        return torch.relu(d).sum()

    _, roof = PH.analyze_step(f, a, b)
    assert roof.flops == 2 * 64 * 32 * 16
    mm = (64 * 32 + 32 * 16 + 64 * 16) * 4
    assert roof.hbm_bytes == mm + 2 * 64 * 16 * 4 + (64 * 16 * 4 + 4)
    assert roof.arg_bytes == (64 * 32 + 32 * 16) * 4
    assert roof.out_bytes == 4
    assert roof.temp_bytes == 2 * 64 * 16 * 4 + 4  # c, relu(d), the sum
    assert roof.bottleneck == "memory"
    assert set(roof.to_dict()) == {
        "flops", "hbm_bytes", "coll_bytes", "coll_by_kind", "coll_counts",
        "xla_flops_once", "t_compute", "t_memory", "t_collective",
        "bottleneck", "roofline_fraction", "arg_bytes", "out_bytes",
        "temp_bytes"}


def test_fake_and_real_cpu_tensors_count_the_same(params_np):
    model = build_model(get_smoke_config(W.TRAIN_ARCH))
    step = make_train_step(model, TrainHParams(**W.TRAIN_HP))
    p = interop.params_from_numpy(params_np, "cpu")
    _, real = PH.analyze_step(step, p, adamw_init(p), {
        k: torch.from_numpy(v) for k, v in batch_np().items()})
    with fake_tensor_mode()():
        fp = model.init(0, device="cpu")
        _, fake = PH.analyze_step(step, fp, adamw_init(fp), {
            k: torch.empty(v.shape, dtype=torch.int32)
            for k, v in batch_np().items()})
    assert fake.to_dict() == real.to_dict()
    n = sum(x.size for x in jax.tree.leaves(params_np))
    batch_bytes = sum(v.nbytes for v in batch_np().values())
    assert real.arg_bytes == 3 * 4 * n + 4 + batch_bytes


@pytest.fixture(scope="module")
def world_counts(params_np):
    return spawn_world(W.cost_rank, 4, params_np, timeout=WORLD_TIMEOUT_S)


def expected_collectives(params_np) -> dict:
    """The operand bytes and calls of one step's collectives on (2, 2), a
    rank, worked out from the leaves' placements, which blocks split over
    ``model``, and the activations' shapes."""
    cfg = get_smoke_config(W.TRAIN_ARCH)
    mesh = MeshShape(("data", "model"), (2, 2))
    leaves, names, treedef = TR.flatten_with_names(params_np)
    specs = TR.flatten_up_to(treedef, params_shardings(params_np, mesh))
    # the blocks on their model shards: the vocabulary and d_ff divide,
    # the 3 heads do not
    kept = {"embed", "head", "w1", "w3", "w2"}
    assert cfg.vocab % 2 == 0 and cfg.d_ff % 2 == 0 and cfg.n_heads % 2
    out = {"gather": 0, "gathers": 0, "scatter": 0, "scatters": 0,
           "allreduce": 4, "allreduces": 1}  # + the loss's mean
    for leaf, name, sh in zip(leaves, names, specs):
        short = name.split("'")[-2]
        stacked = leaf.shape[0] if name.startswith("['layers']") else 1
        whole = leaf.size // stacked * 4         # one layer, f32
        pl = spec_placements(sh.spec, mesh)
        uses = stacked * (2 if stacked > 1 else 1)  # + the recompute
        local = whole // 2 ** sum(p.is_shard() for p in pl)
        if short in kept:          # over data only: one all-gather
            stages, grad = [local], whole // 2
        else:                      # one a sharded mesh dim
            stages = [local * 2 ** i for i in range(sum(p.is_shard()
                                                        for p in pl))]
            grad = whole
        out["gather"] += uses * sum(stages)
        out["gathers"] += uses * len(stages)
        if pl[0].is_shard():       # sharded over data: reduce-scatter
            out["scatter"] += stacked * grad
            out["scatters"] += stacked
        else:
            out["allreduce"] += stacked * grad
            out["allreduces"] += stacked
    # the grad norm: one all-gather of a partial sum a leaf
    out["gather"] += 4 * len(leaves)
    out["gathers"] += 1
    # the sums over model of (4 rows, 32 positions, d) activations: the
    # lookup; each layer's MLP output in forward and its input's gradient
    # in backward (the recompute stops at the w2 product); the loss's
    # input gradient; each CE chunk's (4, 16) max, sum of exp and gold in
    # forward, the first two again in the recompute
    B, S = W.TRAIN_BATCH
    act = B // 2 * S * cfg.d_model * 4
    chunks = S // W.TRAIN_HP["ce_chunk"]
    row = B // 2 * W.TRAIN_HP["ce_chunk"] * 4
    out["allreduce"] += (1 + 2 * cfg.n_layers + 1) * act + chunks * 5 * row
    out["allreduces"] += 1 + 2 * cfg.n_layers + 1 + chunks * 5
    return out


def test_collectives_of_a_smoke_step_on_two_by_two(world_counts, params_np):
    want = expected_collectives(params_np)
    assert (want["gather"], want["gathers"]) == (141_360, 47)
    assert (want["scatter"], want["scatters"]) == (129_024, 16)
    assert (want["allreduce"], want["allreduces"]) == (150_980, 22)
    for r in world_counts:
        real = r["real"]
        assert real["coll_by_kind"] == {
            "all-gather": want["gather"], "reduce-scatter": want["scatter"],
            "all-reduce": want["allreduce"]}
        assert real["coll_counts"] == {
            "all-gather": want["gathers"], "reduce-scatter": want["scatters"],
            "all-reduce": want["allreduces"]}
        assert real["coll_bytes"] == (want["gather"] + want["scatter"]
                                      + want["allreduce"])
        assert r["fake"] == real


def test_collective_kinds_and_rates():
    assert PH.COLLECTIVES == ("all-gather", "all-reduce", "reduce-scatter",
                              "all-to-all", "send/recv")
    assert {k for k, _ in PH._COLLECTIVE_OPS.values()} \
        == set(PH.COLLECTIVES)
    assert (PH.PEAK_FLOPS, PH.HBM_BW, PH.LINK_BW) == (989e12, 3.35e12, 450e9)
    r = PH.Roofline(flops=989e12, hbm_bytes=3.35e12 / 2, coll_bytes=0.0,
                    coll_by_kind={}, coll_counts={}, xla_flops_once=None,
                    arg_bytes=0, out_bytes=0, temp_bytes=0)
    assert r.bottleneck == "compute" and math.isclose(r.t_compute, 1.0)
    assert r.roofline_fraction == 1.0
