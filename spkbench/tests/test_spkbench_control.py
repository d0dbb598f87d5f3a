"""The controls: each cell's plain reference computed in the precision
below the one its configuration states, put in the port's place, must read
as not correct by the numbers the cell compares (at a test's size here;
``spkbench/calibrate.py`` reads them on the card at the cells' own)."""
import pytest

from spkbench.tests import tiny


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_summa_control_in_tf32_is_not_correct(seed):
    from spkbench.cells import summa_worker as cell

    cfg, traffic = tiny.tiny_config(tiny.SUMMA)
    got = cell.control(cfg, traffic, seed, "cpu")
    assert got["c_gap"] > cfg["limits"]["c_gap"]
    assert got["largest_partial"] <= cfg["partial_cap"]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_stream_control_in_bfloat16_is_not_correct(seed):
    from spkbench.cells import stream_service as cell

    cfg, traffic = tiny.tiny_config(tiny.STREAM)
    got = cell.control(cfg, traffic, seed, "cpu")
    assert got["value_gap"] > cfg["limits"]["value_gap"]
