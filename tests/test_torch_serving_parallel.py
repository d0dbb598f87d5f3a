"""The placed serving steps on their ``model`` shards, on the CPU.

``make_prefill_step`` and ``make_decode_step`` on DTensor parameters
placed by the serving layout (``launch.dryrun.serve_shardings``, TP-only),
the batch and tokens by ``batch_shardings`` and the caches by
``cache_shardings`` (the reference's cache layout): each rank runs its
``model`` shard on its rows and its part of the caches, and a decode step
moves no weight. In gloo worlds of 1, 2 and 4 ranks (one
``repro_torch.launch.world.spawn_world`` a world size, run at once; rank
bodies in ``tests/_torch_world.py``), on ``("data", "model")`` meshes (1,
2), (2, 2) and (1, 4), gemma3's also on a ``("pod", "data", "model")``
mesh (2, 1, 2), the smoke configs of gemma3 (ring and global caches;
2 KV heads, so at model = 4 its caches are split along ``head_dim`` and
the scores summed over ``model``), Qwen2-VL (prefill from patch
embeddings), SmolLM-135M (3 heads that divide no model size: its
attention runs whole over a cache split along ``head_dim``), Moonshot
and Llama4-Scout (the experts on their ``model`` shards over each rank's
block of the capacity), Mamba2 and Zamba2 (the SSM state on this rank's
heads, the conv window on its channel block) and Whisper (self- and
cross-attention caches on this rank's heads), each a prefill and
:data:`W.SERVE_TOKENS` decoded tokens:

- the logits and the caches gathered whole within ``RTOL`` (the
  tolerance of ``tests/test_torch_families.py``'s unsharded serving
  tests) of the reference's unsharded prefill (with ``max_len``, which
  its ``make_prefill_step`` does not pass) and ``make_decode_step`` under
  ``jit``, integer leaves equal;
- the same bits on every rank that holds the same rows and cache region;
- each cache shard on ``cache_shardings``' placement, with the shape of
  its local region;
- no weight leaf all-gathered in a decode step (``sharding.api._gathered``,
  the forward gather of ``gather_at_use``, wrapped and counted), while
  the prefill's gathers are seen where training gathers;
- the MoE's buffer on each rank (E / model, ceil(C / data), d), C the
  whole batch's capacity, in prefill and decode;
- on (1, 1) the placed steps bitwise to the plain ones.
"""
import concurrent.futures
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_world as W
from repro.configs import get_smoke_config as ref_smoke
from repro.models import build_model as ref_build_model
from repro.train import make_decode_step as ref_make_decode_step
from repro_torch.configs import get_smoke_config
from repro_torch.launch.world import spawn_world
from repro_torch.models.moe import capacity_for
from test_torch_families import RTOL, scaled_err
from test_torch_train_step import ref_params

WORLD_TIMEOUT_S = 240
CASES = sorted(k for k, (_, m) in W.SERVE_CASES.items() if m != (1, 1))
ONE = sorted(k for k, (_, m) in W.SERVE_CASES.items() if m == (1, 1))


@pytest.fixture(scope="module")
def worlds():
    """``{world size: [each rank's results]}``, the three worlds at
    once."""
    by_arch = {a: jax.tree.map(np.asarray, ref_params(a))
               for a in W.SERVE_ARCHS}
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        futs = {n: pool.submit(spawn_world, W.serving_rank, n, by_arch,
                               timeout=WORLD_TIMEOUT_S) for n in (1, 2, 4)}
        return {n: f.result() for n, f in futs.items()}


def ranks_of(worlds, case):
    _, shape = W.SERVE_CASES[case]
    return [r[case] for r in worlds[int(np.prod(shape))]]


@functools.lru_cache(maxsize=None)
def reference(arch: str) -> list:
    """The reference's unsharded prefill and decode steps under ``jit``
    on :func:`W.serve_inputs`: ``(logits, cache leaves)`` a step."""
    rm = ref_build_model(ref_smoke(arch))
    rp = ref_params(arch)
    batch, toks = W.serve_inputs(rm.cfg)
    B, S = W.SERVE_BATCH
    prefill = jax.jit(functools.partial(
        rm.prefill, max_len=S + W.SERVE_TOKENS, attn_chunk=W.SERVE_CHUNK))
    decode = jax.jit(ref_make_decode_step(rm, attn_chunk=W.SERVE_CHUNK))
    logits, caches = prefill(rp, **{k: jnp.asarray(v)
                                    for k, v in batch.items()})
    out = [(logits, caches)]
    for t in toks:
        logits, caches = decode(rp, caches, jnp.asarray(t))
        out.append((logits, caches))
    return [(np.asarray(lg), [np.asarray(x) for x in jax.tree.leaves(c)])
            for lg, c in out]


@pytest.mark.parametrize("case", CASES)
def test_placed_serving_matches_reference(worlds, case):
    arch = W.SERVE_CASES[case][0]
    ref = reference(arch)
    for rank, res in enumerate(ranks_of(worlds, case)):
        for i, ((rlog, rc), got) in enumerate(zip(ref, res["steps"])):
            what = f"{case} rank {rank} step {i}"
            assert scaled_err(rlog, got["logits"]) <= RTOL, what
            assert len(rc) == len(got["caches"]), what
            for j, (a, b) in enumerate(zip(rc, got["caches"])):
                assert a.shape == b.shape, (what, j)
                if np.issubdtype(a.dtype, np.integer):
                    assert np.array_equal(a, b), (what, j)
                else:
                    assert scaled_err(a, b) <= RTOL, (what, j,
                                                      scaled_err(a, b))


@pytest.mark.parametrize("case", CASES)
def test_ranks_that_share_rows_hold_the_same_bits(worlds, case):
    """Logits on every rank of the same rows, and each cache shard on
    every rank of the same region, bit for bit."""
    ranks = ranks_of(worlds, case)
    for i in range(len(ranks[0]["steps"])):
        rows, shards = {}, {}
        for res in ranks:
            step = res["steps"][i]
            data = tuple(res["coord"][:-1])
            rows.setdefault(data, step["local_logits"].tobytes())
            assert rows[data] == step["local_logits"].tobytes(), (case, i)
            for j, (region, x) in enumerate(zip(step["regions"],
                                                step["local_caches"])):
                key = (j, tuple(map(tuple, region)))
                shards.setdefault(key, x.tobytes())
                assert shards[key] == x.tobytes(), (case, i, j)
        assert len(rows) == int(np.prod(W.SERVE_CASES[case][1][:-1]))


@pytest.mark.parametrize("case", CASES)
def test_cache_shards_lie_on_cache_shardings(worlds, case):
    for res in ranks_of(worlds, case):
        for i, step in enumerate(res["steps"]):
            assert all(step["on_shardings"]), (case, i)


@pytest.mark.parametrize("case", CASES)
def test_decode_gathers_no_weight(worlds, case):
    for res in ranks_of(worlds, case):
        assert res["gathers"]["decode"] == 0, case


@pytest.mark.parametrize("case", ["mamba2_370m/tp4", "zamba2_2_7b/dp2xtp2",
                                  "gemma3_27b/tp4", "qwen2_vl_72b/tp4"])
def test_the_count_sees_the_prefills_gathers(worlds, case):
    """The wrapped gather is the one a layer calls: the Mamba2 block's
    ``in_proj`` gathered whole, and at model = 4 the one-KV-head
    ``wk``/``wv``, gathered in prefill as in training."""
    for res in ranks_of(worlds, case):
        assert res["gathers"]["prefill"] > 0, case


MOE_CASES = [k for k in CASES if get_smoke_config(
    W.SERVE_CASES[k][0]).family == "moe"]


@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_buffer_is_this_ranks_block(worlds, case):
    """Prefill's and each decode's buffer: the rank's E / model experts
    over its ceil(C / data) slots of the whole batch's capacity."""
    cfg = get_smoke_config(W.SERVE_CASES[case][0])
    shape = W.SERVE_CASES[case][1]
    data, model = int(np.prod(shape[:-1])), shape[-1]
    B, S = W.SERVE_BATCH
    E = cfg.n_experts // model
    want = ([(E, -(-capacity_for(B * S, cfg) // data), cfg.d_model)]
            * cfg.n_layers
            + [(E, -(-capacity_for(B, cfg) // data), cfg.d_model)]
            * cfg.n_layers * W.SERVE_TOKENS)
    for res in ranks_of(worlds, case):
        assert res["buffers"] == want


@pytest.mark.parametrize("case", ONE)
def test_world_one_is_bitwise_the_plain_steps(worlds, case):
    (res,) = ranks_of(worlds, case)
    for i, (got, want) in enumerate(zip(res["steps"], res["plain"])):
        assert got["logits"].tobytes() == want["logits"].tobytes(), i
        assert len(got["caches"]) == len(want["caches"])
        for a, b in zip(got["caches"], want["caches"]):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), i
