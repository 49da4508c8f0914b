"""The control of every cell comes out as not correct: the plain
reference in the nearest lower precision (its colour arithmetic in
bfloat16), put in the program's place, fails the cell's own limits, while the
program's frames pass them.  A test-sized run of each cell; the readings
at the cells' own sizes on the card are in ``PERF.md``."""

import pytest

from conftest import tiny
from perfbench import harness

CELLS = ("syn512_orbit", "d11_parked", "syn512_parked")


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(cell, cache_root):
    cfg, mix = tiny(cell)
    res, _ = harness.run_cell(cell, 2 ** 31 + 77, 0.3, False, device="cpu",
                              root=cache_root, cfg=cfg, mix=mix,
                              control=True, log=lambda m: None)
    assert res["correct"] is True, res["checked"]
    limits = {k: v["limit"] for k, v in res["checked"].items()}
    assert any(res["control"][k] > limits[k] for k in limits), \
        (res["control"], limits)
