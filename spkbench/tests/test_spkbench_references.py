"""The plain references and the generators: the references agree with the
port at tiny sizes on the CPU, and the generators draw what they say."""
import numpy as np
import pytest
import torch

from spkbench.reference import generators as gens
from spkbench.reference import laws
from spkbench.reference import roofline
from spkbench.reference import stream as sref
from spkbench.reference import summa as mref
from spkbench.tests import tiny


def test_summa_reference_agrees_with_the_port():
    from repro_torch.core import spgemm

    from spkbench.cells import summa_worker as cell

    cfg, traffic = tiny.tiny_config(tiny.SUMMA)
    _, _, stages, cap = cell.sizes(cfg)
    for pair in range(2):
        a, b = cell.stripes(cfg, 7, pair, "cpu")
        got = spgemm.summa_block(a, b, stages, algorithm="auto",
                                 partial_cap_per_stage=cap)
        want, fill = mref.worker_block(a, b, stages, "float64")
        assert 0 < fill < cap
        assert mref.relative_gap(got, want) < 1e-6
        assert mref.support_gap(got, want) == 0


def test_summa_reference_sums_every_partial_whole():
    a = torch.tensor([[1.0, 3.0], [-2.0, 0.5]])
    b = torch.tensor([[1.0, 0.0], [0.0, 2.0]])
    got, fill = mref.worker_block(a, b, 2, "float64")
    assert fill == 2
    want = torch.tensor([[1.0, 6.0], [-2.0, 1.0]], dtype=torch.float64)
    assert torch.equal(got, want)
    assert mref.support_gap(got, torch.where(got > 5, 0.0, got)) == 1


def test_stream_reference_agrees_with_the_port():
    from spkbench.cells import stream_service as cell

    cfg, traffic = tiny.tiny_config(tiny.STREAM)
    st = cell.setup(cfg, traffic, 11, "cpu")
    cell.run_events(st, until_t=60.0)
    values, counts, last_t = cell.state_of(st)
    ev = st["events"]
    used = int(ev.push[:st["next"]].max()) + 1
    want = sref.replay(cfg, ev, st["next"],
                       st["pushes"].keys[:used].numpy().astype(np.int64),
                       st["pushes"].vals[:used].numpy(), last_t)
    assert sref.value_gap(values, want) == 0.0
    assert sref.count_gap(counts, want) == 0
    assert max(len(t.keys) for t in want.tenants) == cfg["cap_budget"]


def test_stream_reference_defers_past_the_soft_watermark():
    cfg = {"cap_budget": 8, "shape": [4, 4], "batch_k": 2,
           "soft_pending_nnz": 4, "hard_pending_nnz": 100,
           "flush_deadline": 1.0, "max_coflush_windows": 8, "tenants": 2}
    keys = np.arange(12, dtype=np.int64).reshape(6, 2)
    ref = sref.StreamReference(cfg, keys, np.ones((6, 2), np.float32))
    for tenant, push in ((0, 0), (1, 1), (0, 2), (1, 3)):
        # the last two pass the soft line but complete an open window
        assert ref.push(tenant, push)
        ref.seal_full(tenant, 0.0)
    assert not ref.push(0, 4)  # would open a new window past the line
    assert ref.tenants[0].counts == {"admitted": 2, "deferred": 1,
                                     "flushed_windows": 0, "flushes": 0}
    assert ref.tick(1.0) == 8 and ref.pending == 0
    assert ref.tenants[0].counts["flushes"] == 1


GRAPH = {"permute_labels": True,
         "positions": {"law": "kronecker", "initiator": [0.57, 0.19, 0.19]}}
SIZES = {"scale": 9, "edgefactor": 16, "tile": 64, "device": "cpu"}


def test_graph_stripes_are_seeded_and_symmetric():
    def draw(seed):
        g = gens.torch_generator(seed, (1, 0), "cpu")
        return gens.graph_stripes(g, GRAPH, **SIZES)
    (a, b), (a2, b2) = draw(5), draw(5)
    assert torch.equal(a, a2) and torch.equal(b, b2)
    assert not torch.equal(a, draw(6)[0])
    assert a.shape == (64, 512) and b.shape == (512, 64)
    assert torch.equal(b, a.T)
    # A = E + E^T: its leading 64 x 64 block is symmetric
    assert torch.equal(a[:, :64], a[:, :64].T)
    assert float(a.min()) >= 0.0


def test_graph_stripes_take_their_law_by_name():
    g = gens.torch_generator(5, (1, 0), "cpu")
    a, _ = gens.graph_stripes(g, dict(GRAPH, positions={"law": "uniform"}),
                              **SIZES)
    # 2 x 16 x 512 endpoints, a share 64 / 512 of them in the stripe's
    # rows, few of them meeting
    uniform = int((a != 0).sum())
    assert 0.8 * 2048 < uniform < 1.2 * 2048
    # the Kronecker law's edges crowd onto a few vertices and meet more
    kron = sum(int((gens.graph_stripes(
        gens.torch_generator(s, (1, 0), "cpu"), GRAPH, **SIZES)[0] != 0)
        .sum()) for s in range(8))
    assert kron < 8 * 0.8 * 2048
    with pytest.raises(ModuleNotFoundError):
        gens.graph_stripes(g, dict(GRAPH, positions={"law": "no_such"}),
                           **SIZES)


@pytest.mark.parametrize("law", [{"law": "uniform"},
                                 {"law": "kronecker",
                                  "initiator": [0.57, 0.19, 0.19]}])
def test_coo_pushes_are_distinct_sorted_and_normal(law):
    g = gens.torch_generator(3, (1,), "cpu")
    p = gens.coo_pushes(g, 50, m=64, n=16, nnz=40, law=law, device="cpu",
                        block=16)
    assert p.keys.shape == (50, 40) and p.keys.dtype == torch.int32
    assert bool((p.keys[:, 1:] > p.keys[:, :-1]).all())
    assert int(p.keys.min()) >= 0 and int(p.keys.max()) < 64 * 16
    assert bool((p.vals.abs() >= gens.F32_TINY).all())


def test_kronecker_draws_graph500_s_quadrants():
    g = gens.torch_generator(4, (1,), "cpu")
    row, col = laws.positions({"law": "kronecker",
                               "initiator": [0.57, 0.19, 0.19]},
                              g, 40000, m=1024, n=1024, device="cpu")
    top, left = row < 512, col < 512
    for share, want in ((top & left, 0.57), (top & ~left, 0.19),
                        (~top & left, 0.19), (~top & ~left, 0.05)):
        assert abs(float(share.double().mean()) - want) < 0.01
    # a wider side's further levels take the marginal alone
    row, col = laws.positions({"law": "kronecker"}, g, 40000, m=1024,
                              n=256, device="cpu")
    assert int(row.max()) < 1024 and int(col.max()) < 256
    assert abs(float((row < 512).double().mean()) - 0.76) < 0.01
    assert abs(float((col < 128).double().mean()) - 0.76) < 0.01


def test_stream_events_are_seeded_and_ordered():
    a = gens.stream_events(9, tenants=3, rate=4.0, sim_seconds=5.0,
                           tick_every=0.25)
    b = gens.stream_events(9, tenants=3, rate=4.0, sim_seconds=5.0,
                           tick_every=0.25)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert np.all(np.diff(a.t) >= 0)
    assert int((a.tenant < 0).sum()) == 20
    pushes = a.push[a.tenant >= 0]
    assert np.array_equal(pushes, np.arange(pushes.size))
    same = np.flatnonzero(np.diff(a.t) == 0)
    assert all(a.tenant[i] >= 0 or a.tenant[i + 1] < 0 for i in same)


def test_roundings_match_torch():
    x = torch.randn(1000, generator=torch.Generator().manual_seed(1))
    assert np.array_equal(sref.bf16_round(x.numpy()),
                          x.to(torch.bfloat16).float().numpy())
    t = mref.tf32_round(x)
    assert bool(((t.view(torch.int32) & 0x1FFF) == 0).all())
    assert float(((t - x).abs() / x.abs()).max()) <= 2.0 ** -11


def test_roofline_arithmetic():
    assert roofline.bound_s(nbytes=3.35e12) == pytest.approx(1.0)
    assert roofline.bound_s(flops=67e12, nbytes=1.0) == pytest.approx(1.0)
    assert roofline.share_pct(0.5, 1.0) == 50.0
    assert roofline.share_pct(0.5, 0.0) is None
    assert roofline.matmul_flops(2, 3, 4) == 48
