"""The MoE combine (``repro_torch.kernels.moe_combine``) on the CPU.

The plain version is held bitwise to the reference's ordered scatter-add
``y.at[tok].add(contrib)`` on the reference's own contributions, and to
the ordered segment fold over the token-major layout that the combine used
before it had a kernel of its own, on inputs that carry subnormals, signed
zeros, infinities and NaNs of both signs. On the CPU the wrapper runs the
plain version and launches nothing; the kernel itself is held to the plain
version on the card (``tests/test_torch_cuda.py``).
"""
import functools
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.compat import fake_tensor_mode
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import moe_combine as MC
from repro_torch.kernels import segment, vec_accum
from repro_torch.launch import dryrun
from repro_torch.models import moe as TM
from test_torch_cuda import COMBINE_EDGES, bits, combine_planted
from test_torch_moe import CASES, IDS, configs, draw, ref_moe


@functools.lru_cache(maxsize=None)
def load_chip_smoke():
    """``chip_smoke.py`` as a module (its ``segment_route``)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(repo, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    return chip_smoke


#: ``test_torch_moe``'s cases at capacity factors that drop assignments
#: (0.5) or keep nearly all (1.25), each family once at least.
SCATTER_CASES = [(c, i) for c, i in zip(CASES, IDS) if c[1] in (0.5, 1.25)]


@pytest.mark.parametrize("arch,cf,k", [c for c, _ in SCATTER_CASES],
                         ids=[i for _, i in SCATTER_CASES])
def test_plain_bitwise_to_reference_scatter_add(arch, cf, k, monkeypatch):
    """The reference's ``y.at[tok].add(contrib)`` of its own gated
    contributions, laid out token by token (a dropped assignment +0.0)."""
    rcfg, cfg = configs(arch, cf, k)
    rp, _, x = draw(rcfg, seed=3)
    _, _, ref = ref_moe(rp, jnp.asarray(x), rcfg, monkeypatch)
    T, K = x.shape[0] * x.shape[1], cfg.moe_topk
    d = TM.dispatch(torch.from_numpy(ref["expert"].copy()), cfg.n_experts,
                    TM.capacity_for(T, cfg))
    pos = TM.token_order(d, T, K).reshape(-1)
    gated = ref["contrib"] * ref["gate"].reshape(-1)[ref["order"]][:, None]
    contrib = torch.where(d.keep[pos, None], torch.from_numpy(gated)[pos],
                          0.0).reshape(T, K, -1)
    y = MC.moe_combine_plain(contrib)
    assert np.array_equal(bits(y), ref["y"].reshape(y.shape).view(np.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [1, 7, 96])
@pytest.mark.parametrize("K", [1, 2, 6, 9])
def test_plain_bitwise_to_the_segment_fold_route(K, d, dtype):
    c = combine_planted(K * 100 + d, dtype, 40, K, d)
    got = MC.moe_combine_plain(c)
    want = load_chip_smoke().segment_route(torch, segment.segment_fold_plain,
                                           c)
    assert got.dtype == dtype and got.shape == (40, d)
    assert np.array_equal(bits(got), bits(want))
    assert not np.signbit(got[1].float().numpy()).any()  # -0.0 + ... = +0.0


def test_k1_is_an_add_from_plus_zero():
    c = torch.from_numpy(COMBINE_EDGES[None, None, :].copy())
    y = MC.moe_combine_raw(c)[0].numpy()
    assert y[5] == 0.0 and not np.signbit(y[5])  # -0.0 -> +0.0
    # subnormals flush to a zero of their sign, and +0.0 + -0.0 is +0.0
    assert (y[:4] == 0.0).all() and not np.signbit(y[:4]).any()
    assert y.view(np.uint32)[8:10].tolist() == [0x7FC00000, 0xFFC00000]


def test_combine_on_cpu_launches_nothing_and_folds_no_segments(monkeypatch):
    """The CPU path is the plain version: no launch, no segment fold, and
    the wrapper is handed the contributions as they lie (no layout copy)."""
    def refuse(*a, **k):
        raise AssertionError("the combine reached the segment fold")

    before = (MC.moe_combine_raw.launches, segment.segment_fold.launches)
    fold = segment.segment_fold
    for mod, name in ((segment, "segment_fold"),
                      (segment, "segment_fold_plain"),
                      (vec_accum, "fold_runs")):
        monkeypatch.setattr(mod, name, refuse)
    seen = []

    def recording(contrib):
        seen.append(contrib)
        return MC.moe_combine_raw(contrib)

    monkeypatch.setattr(TM, "moe_combine_raw", recording)
    c = combine_planted(7, torch.float32, 24, 6, 16)
    y = TM.combine(c)
    assert seen and seen[0] is c
    assert (MC.moe_combine_raw.launches, fold.launches) == before
    assert np.array_equal(bits(y), bits(MC.moe_combine_plain(c)))
    assert TM.combine_plain is MC.moe_combine_plain


@pytest.mark.parametrize("bad,err", [
    (torch.zeros(4, 8), ValueError),
    (torch.zeros(2, 4, 3, 8), ValueError),
    (torch.zeros(4, 2, 8, dtype=torch.float16), TypeError),
    (torch.zeros(4, 2, 8, dtype=torch.int32), TypeError),
    (torch.zeros(4, 2, 8, device="meta"), ValueError),
], ids=["rank2", "rank4", "f16", "int32", "meta"])
def test_wrapper_refuses_rank_type_and_device(bad, err):
    with pytest.raises(err, match="moe_combine_raw"):
        MC.moe_combine_raw(bad)


def test_launch_geometry():
    """One thread a 16-byte group of a token row, or an element; a row of
    blocks a token."""
    g = MC.launch_geometry(16384, 6, 2048, torch.bfloat16, aligned=True)
    assert g == {"vectorized": True, "items": 16384 * 256, "blocks": 16384,
                 "row_blocks": 1, "threads": MC.THREADS}
    g = MC.launch_geometry(4096, 1, 5120, torch.bfloat16, aligned=True)
    assert (g["row_blocks"], g["blocks"]) == (3, 3 * 4096)
    assert MC.launch_geometry(10, 6, 2048, torch.float32,
                              aligned=True)["items"] == 10 * 512
    assert not MC.launch_geometry(10, 6, 7, torch.bfloat16,
                                  aligned=True)["vectorized"]
    g = MC.launch_geometry(10, 6, 2048, torch.bfloat16, aligned=False)
    assert not g["vectorized"] and g["items"] == 10 * 2048
    assert (g["row_blocks"], g["blocks"]) == (8, 80)


def test_fake_trace_of_a_moonshot_layer_under_the_stand_in(monkeypatch):
    """The dry-run's stand-in gives the combine's shape on fake tensors
    and is the only combine the trace reaches."""
    calls = []
    shape_only = dryrun._moe_combine_shape

    def counting(contrib):
        calls.append(tuple(contrib.shape))
        return shape_only(contrib)

    monkeypatch.setattr(dryrun, "_moe_combine_shape", counting)
    cfg = get_smoke_config("moonshot-v1-16b-a3b")
    with fake_tensor_mode()(), dryrun._shape_only_combine():
        params = TM.init_moe_params(torch.Generator().manual_seed(0), cfg)
        x = torch.empty((2, 16, cfg.d_model))
        y, aux = TM.moe_ffn(params, x, cfg)
        assert TM.moe_combine_raw is not MC.moe_combine_raw
    assert TM.moe_combine_raw is MC.moe_combine_raw
    assert y.shape == (2, 16, cfg.d_model) and aux.shape == ()
    assert calls == [(32, cfg.moe_topk, cfg.d_model)]
