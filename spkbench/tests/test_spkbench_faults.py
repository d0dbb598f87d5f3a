"""A run with the timed path broken underneath reads ``correct`` false: for
each fault a cell can have, planted in the port, with the rest of the run
(set-up, window, check) as the command drives it. Neither cell has an
exchange between chips to leave out."""
import pytest

from spkbench.tests import tiny


def _half_the_stages(real):
    def partials(a, b, stages, cap):
        out = real(a, b, stages, cap)
        return out[:len(out) // 2]
    return partials


def _altered_tile(real):
    def block(*args, **kw):
        c = real(*args, **kw)
        c[c.shape[0] // 3, c.shape[1] // 2] += 1.0
        return c
    return block


def _partials_cut(real):
    def partials(a, b, stages, cap):
        return real(a, b, stages, 64)
    return partials


@pytest.mark.parametrize("fault, number", [
    ("half_the_batch", "c_gap"), ("half_the_batch", "c_support_gap"),
    ("answer_altered", "c_gap"), ("partials_cut", "c_support_gap")])
def test_summa_fault_is_caught(monkeypatch, fault, number):
    from repro_torch.core import spgemm

    if fault == "half_the_batch":
        monkeypatch.setattr(spgemm, "summa_partials",
                            _half_the_stages(spgemm.summa_partials))
    elif fault == "partials_cut":
        monkeypatch.setattr(spgemm, "summa_partials",
                            _partials_cut(spgemm.summa_partials))
    else:
        monkeypatch.setattr(spgemm, "summa_block",
                            _altered_tile(spgemm.summa_block))
    out = tiny.run(tiny.SUMMA)
    assert out["correct"] is False
    assert out["checks"][number]["value"] > out["checks"][number]["limit"]


def _state_unchanged(real):
    def fold(colls, **kw):
        return [c[0] for c in colls]
    return fold


def _half_the_windows(real):
    def fold(colls, **kw):
        return real([c[:1 + (len(c) - 1) // 2] for c in colls], **kw)
    return fold


def _value_altered(real):
    def fold(colls, **kw):
        out = real(colls, **kw)
        a = out[0]
        vals = a.vals.clone()
        vals[0] = vals[0] + 1.0
        out[0] = a._replace(vals=vals)
        return out
    return fold


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_windows,
                                   _value_altered])
def test_stream_fault_is_caught(monkeypatch, fault):
    from repro_torch.core import stream_service

    monkeypatch.setattr(stream_service, "spkadd_batched_ragged",
                        fault(stream_service.spkadd_batched_ragged))
    out = tiny.run(tiny.STREAM)
    assert out["correct"] is False
    assert (out["checks"]["value_gap"]["value"]
            > out["checks"]["value_gap"]["limit"])


def test_sound_runs_are_correct():
    assert tiny.run(tiny.SUMMA)["correct"] is True
    assert tiny.run(tiny.STREAM)["correct"] is True
