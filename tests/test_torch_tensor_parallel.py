"""The sharded dense step's tensor parallelism, on the CPU.

``make_train_step`` on DTensor parameters gathers each layer's weights
where it uses them and splits every family's blocks over the mesh's
``model`` dim as the reference's specs do: the attention on its heads,
the MLP on its ``d_ff`` columns, the Mamba2 block on its SSM heads, the
MoE on its experts, the embedding and loss on the vocabulary
(``repro_torch.sharding.api``: ``gather_at_use``, ``model_split``,
``attn_split`` and the Megatron pair). In gloo worlds of 2 and 4 ranks
(one spawn a world size, ``repro_torch.launch.world.spawn_world``; rank
bodies in ``tests/_torch_world.py``), on ``("data", "model")`` meshes
(1, 2), (2, 2) and (1, 4), and gemma3's and Zamba2's also on a
``("pod", "data", "model")`` mesh (2, 1, 2):

- the smoke configs of gemma3 (local:global groups; 4 heads and 2 KV
  heads, which at model = 4 are replicated in pairs), Qwen2-VL (patch
  embeddings and M-RoPE positions of three distinct streams), StableLM
  and InternLM2, and on (2, 2) and (1, 4) those of Mamba2 and Zamba2
  (8 SSM heads; ``in_proj``'s 296 columns, which pack z, x, B, C and dt,
  gathered whole and each rank's heads' columns taken; the gated norm's
  mean of squares summed over ``model``), Zamba2's shared block (4 heads
  and 4 KV heads, gathered and split at each of its sites) and
  Whisper's encoder, decoder and cross-attention (4 heads) and MLPs, two
  steps each: params, moments, loss and grad norm within
  ``tests/test_torch_train_step.py``'s tolerances of the reference's
  unsharded ``jit`` step, and the same bits on every rank; each rank's
  SSD scan on (B / data, S, H / model, P) and each split attention's
  ``q`` on n_heads / model heads;
- the MoE's experts on their ``model`` shards over this rank's block of
  the capacity (``models/moe.py``): Moonshot's smoke config on (2, 2),
  and at capacity factor 1.0 (the capacity binds and drops) on (2, 2),
  (1, 4), (4, 1) and (2, 1, 2) (``pod``: the buffer replicated there),
  Llama4-Scout's on (1, 4), held as above; each
  rank's dispatch buffer (E / model, ceil(C / data), d) and its ``we1``
  (E / model, d, d_ff);
- the vocabulary-parallel cross-entropy against ``chunked_ce`` on the
  whole head, with labels on the first and last column of every rank's
  block of the vocabulary; fault G: a label outside the vocabulary
  raises ``ValueError`` on the whole head and on the head split over
  ``model`` (1, 2);
- on a (2, 1) mesh, one step of gemma3's smoke config on fake tensors:
  the gathers never hold more than one layer's leaves and the top leaves
  at once.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Shard

import _torch_world as W
from repro.configs import get_smoke_config as ref_smoke
from repro.models import build_model as ref_build_model
from repro.optim import adamw_init as ref_adamw_init
from repro.train import TrainHParams as RefHP
from repro.train import make_train_step as ref_make_train_step
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch.world import spawn_world
from repro_torch.models.moe import capacity_for
from repro_torch.models.transformer import chunked_ce
from repro_torch.optim import cosine_schedule
from repro_torch.train import TrainHParams
from test_torch_train_step import (RTOL_METRIC, TOL, assert_leaves_close,
                                   ref_params)

WORLD_TIMEOUT_S = 240
CASES = sorted(W.TP_CASES)
#: The vocabulary-parallel CE against the whole head's: f32 sums in
#: another order.
CE_RTOL = 1e-5


@pytest.fixture(scope="module")
def worlds():
    """``{world size: [each rank's results]}``."""
    by_arch = {a: jax.tree.map(np.asarray, ref_params(a))
               for a in sorted({a for a, _ in W.TP_CASES.values()})}
    return {n: spawn_world(W.tensor_parallel_rank, n, by_arch,
                           timeout=WORLD_TIMEOUT_S) for n in (2, 4)}


def ranks_of(worlds, case):
    _, shape = W.TP_CASES[case]
    return [r[case] for r in worlds[int(np.prod(shape))]]


_REF = {}


def ref_steps(case: str):
    """The reference's unsharded step on ``case``'s smoke config: params,
    moments and metrics after :data:`W.TP_STEPS` steps."""
    arch, _ = W.TP_CASES[case]
    cfg = W.tp_config(case, ref_smoke)
    key = (arch, cfg.capacity_factor)
    if key not in _REF:
        step = jax.jit(ref_make_train_step(ref_build_model(cfg),
                                           RefHP(**W.TRAIN_HP)))
        p = ref_params(arch)
        o = ref_adamw_init(p)
        mets = []
        for s in range(W.TP_STEPS):
            b = {k: jnp.asarray(v) for k, v in W.tp_batch(s, cfg).items()}
            p, o, met = step(p, o, b)
            mets.append({k: float(v) for k, v in met.items()})
        _REF[key] = (jax.tree.leaves(p), jax.tree.leaves(o.mu),
                     jax.tree.leaves(o.nu), mets)
    return _REF[key]


def lr_sum() -> float:
    hp = W.TRAIN_HP
    return sum(float(cosine_schedule(
        torch.tensor(s), peak_lr=TrainHParams().peak_lr, warmup=hp["warmup"],
        total=hp["total_steps"])) for s in range(W.TP_STEPS))


@pytest.mark.parametrize("case", CASES)
def test_model_split_step_matches_reference(worlds, case):
    rp, rmu, rnu, rmets = ref_steps(case)
    if case in W.TP_CAPACITY:
        assert sum(res["dropped"] for res in ranks_of(worlds, case)) > 0
    for rank, res in enumerate(ranks_of(worlds, case)):
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
def test_model_split_step_is_bit_identical_on_every_rank(worlds, case):
    ranks = ranks_of(worlds, case)
    for res in ranks[1:]:
        for a, b in zip(ranks[0]["metrics"], res["metrics"]):
            assert a["grad_norm_bits"] == b["grad_norm_bits"]
            assert a["loss"] == b["loss"]
        for kind in ("params", "mu", "nu"):
            for a, b in zip(ranks[0][kind], res[kind]):
                assert a.tobytes() == b.tobytes(), kind


MOE_CASES = [k for k in CASES if get_smoke_config(W.TP_CASES[k][0]).family
             == "moe"]


@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_buffer_is_this_ranks_block(worlds, case):
    """A rank gathers only its ``model`` rank's experts (over the data
    axes) and runs them over its block of the capacity: the buffer is
    (E / model, ceil(C / data), d), C the whole batch's capacity."""
    cfg = W.tp_config(case, get_smoke_config)
    shape = W.TP_CASES[case][1]
    data, model = shape[-2], shape[-1]
    B, S = W.TRAIN_BATCH
    C = capacity_for(B * S, cfg)
    E = cfg.n_experts // model
    want = [((E, -(-C // data), cfg.d_model), (E, cfg.d_model, cfg.d_ff))]
    for res in ranks_of(worlds, case):
        assert res["buffers"] == want


FAMILY_CASES = [k for k in CASES if W.TP_CASES[k][0] in W.TP_FAMILY_ARCHS]


@pytest.mark.parametrize("case", FAMILY_CASES)
def test_blocks_run_on_this_ranks_heads(worlds, case):
    """Each rank's SSD scan takes ``x`` on its SSM heads, (B / data, S, H
    / model, P), and each attention (Zamba2's shared block at its sites,
    Whisper's encoder, decoder and cross-attention) ``q`` on its
    n_heads / model heads of the rank's rows."""
    cfg = W.tp_config(case, get_smoke_config)
    shape = W.TP_CASES[case][1]
    data, model = int(np.prod(shape[:-1])), shape[-1]
    B, S = W.TRAIN_BATCH
    rows = B // data
    for res in ranks_of(worlds, case):
        want = ([(rows, S, cfg.n_ssm_heads // model, cfg.ssm_head_dim)]
                if cfg.family in ("ssm", "hybrid") else [])
        assert res["scans"] == want
        if cfg.family == "ssm":
            assert res["queries"] == []
            continue
        assert res["queries"]
        assert {(q[0],) + q[2:] for q in res["queries"]} == {
            (rows, cfg.n_heads // model, cfg.head_dim)}


@pytest.mark.parametrize("path", ["whole", "split"])
@pytest.mark.parametrize("bad", W.CE_REFUSED)
def test_ce_refuses_a_label_outside_the_vocabulary(worlds, path, bad):
    """Fault G: with the head split over ``model`` a label outside
    ``[0, vocab)`` used to count as a gold logit of 0; whole, ``gather``
    raised a ``RuntimeError``. Both now raise ``ValueError``."""
    for res in worlds[2]:
        assert res["ce_refused"][path, bad] == "ValueError"


@pytest.mark.parametrize("vocab", [W.CE_VOCAB, W.CE_VOCAB_ODD])
@pytest.mark.parametrize("T", [2, 4])
def test_vocabulary_parallel_ce_matches_the_whole_head(worlds, T, vocab):
    """On the model shards where the vocabulary divides; gathered whole
    where it does not (the spec drops the axis)."""
    x, head, labels = (torch.from_numpy(a) for a in W.ce_inputs(T, vocab))
    x.requires_grad_()
    head.requires_grad_()
    loss = chunked_ce(x, head, labels, chunk=4)
    gx, gh = torch.autograd.grad(loss, (x, head))
    loss = float(loss.detach())
    cols = vocab // T
    assert {int(c) for c in labels.reshape(-1)} >= {
        c for r in range(T) for c in (r * cols, (r + 1) * cols - 1)}
    split = vocab % T == 0
    for res in worlds[T]:
        ce = res["ce" if vocab == W.CE_VOCAB else "ce_odd"]
        assert (ce["placements"][1] == str(Shard(1))) == split
        assert abs(ce["loss"] - loss) <= CE_RTOL * abs(loss)
        assert_leaves_close([gx.numpy(), gh.numpy()],
                            [ce["dx"], ce["dhead"]], tol=TOL)


@pytest.mark.parametrize("arch", W.TP_ARCHS + ("smollm_135m",))
def test_vocabularies_divide_over_model(arch):
    """The dense configs' vocabularies, full and smoke, divide over 2, 4
    and 16 model ranks, so their embedding and loss run on their shards
    on the production mesh and in these worlds."""
    for cfg in (get_config(arch), get_smoke_config(arch)):
        assert all(cfg.vocab % t == 0 for t in (2, 4, 16)), cfg.vocab


def test_live_gathered_bytes_are_one_layer_and_the_top_leaves(worlds):
    """At most one layer's gathered leaves and the embedding and head at
    once (the whole-tree gather held every leaf). Printed (``-s``)."""
    for res in worlds[2]:
        live = res["live"]
        print(f"\n(2, 1) gemma3 smoke step on fake tensors: {live}")
        assert live["calls"] > 0
        assert live["peak"] <= live["layer"] + live["top"]
        assert live["layer"] + live["top"] < live["tree"] // 2
