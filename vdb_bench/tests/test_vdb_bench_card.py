"""On a card: a serving cell at a small size through the built kernels,
correct and traced, and the control, the program's own int8 path, not
correct at the cell's own size. Run there with
``python -m pytest vdb_bench/tests -m cuda``."""

import pytest
import torch

from vdb_bench.control import read
from vdb_bench.run import run_cell

SMALL = {"config": {"n": 300_000}, "mix": {"request_queries": 2000}}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_small_cell_on_the_card():
    dev = _card()
    line = run_cell("deep96.serve-full", 41, 2.0, True, dev,
                    overrides=SMALL)
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    assert 0 < line["metrics"]["scan_roofline_pct"]["value"] <= 100
    ctl = read("deep96.serve-full", 41, "fp8-reference", 0.0, dev, SMALL)
    assert ctl["correct"] is False


@pytest.mark.cuda
def test_int8_path_fails_at_the_cells_size():
    """One request of the cell as it is (10M rows, 10,000 queries): the
    program correct, its int8f path not, on the nearest rows lost."""
    dev = _card()
    sound = read("deep96.serve-full", 43, "program", 0.0, dev)
    assert sound["correct"] is True
    ctl = read("deep96.serve-full", 43, "int8f", 0.0, dev)
    assert ctl["correct"] is False
    assert ctl["checks"]["nn_missed"]["value"] > \
        ctl["checks"]["nn_missed"]["limit"]
