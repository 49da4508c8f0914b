"""The output check sees a broken timed path: the whole run (past the
look for a card) with the program broken underneath must end with
``correct`` false, once for each fault the cell can have.  A parked
camera's frame does not change, so a frame returned unchanged is a fault
only of the moving cells; one card has no exchange to leave out."""

import functools

import pytest
import torch

from conftest import tiny
from perfbench import harness

CELLS = ("syn512_orbit", "d11_parked", "syn512_parked")
FAULTS = ("unchanged", "half_left_out", "altered")


def _producers():
    from mega_nerf_viewer_tpu_torch.ops import accel
    return [(accel, "render_frame_fast_segmented", lambda out: out[0]),
            (accel, "render_frame_fast", lambda out: out[0])]


def _break(img, fault):
    flat = img.reshape(-1, img.shape[-1])
    if fault == "half_left_out":
        flat[flat.shape[0] // 2:] = 0.0
    elif fault == "altered":
        flat[:, :3] += 0.01


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_makes_correct_false(cell, fault, monkeypatch, cache_root):
    cfg, mix = tiny(cell)
    if fault == "unchanged" and mix["kind"] == "parked":
        pytest.skip("a parked frame is unchanged by design")
    from mega_nerf_viewer_tpu_torch import Viewer
    if fault == "unchanged":
        first = {}
        orig = Viewer.render

        def stale(self, *a, **kw):
            out = orig(self, *a, **kw)
            return first.setdefault("img", out.clone())
        monkeypatch.setattr(Viewer, "render", stale)
    else:
        for mod, name, pick in _producers():
            fn = getattr(mod, name)

            def broken(*a, _fn=fn, _pick=pick, **kw):
                out = _fn(*a, **kw)
                _break(_pick(out), fault)
                return out
            monkeypatch.setattr(mod, name, functools.wraps(fn)(broken))
    res, _ = harness.run_cell(cell, 4242, 0.3, False, device="cpu",
                              root=cache_root, cfg=cfg, mix=mix,
                              log=lambda m: None)
    assert res["correct"] is False, res["checked"]
    assert res["failed"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, cache_root):
    cfg, mix = tiny(cell)
    res, _ = harness.run_cell(cell, 4242, 0.3, False, device="cpu",
                              root=cache_root, cfg=cfg, mix=mix,
                              log=lambda m: None)
    assert res["correct"] is True, res["checked"]
    assert torch.tensor([v["value"] for v in res["checked"].values()]
                        ).isfinite().all()
