"""The port's profiling module (``utils/profiling.py``): ``trace`` onto
``torch.profiler`` and ``annotate`` onto ``record_function`` (the JAX
package's are ``jax.profiler``'s).  Its spans and counters are held in
``test_torch_tracing.py``."""

import json
import os

import numpy as np

import mega_nerf_viewer_tpu_torch as P
from mega_nerf_viewer_tpu_torch.utils import profiling as PPR


def test_trace_holds_the_annotated_frame(tmp_path):
    """``trace`` around two Viewer frames writes a Chrome trace that holds
    the ``annotate`` region and the frames' operators."""
    cam = P.Camera(16, 12, 14.0)
    cam.center = np.array([-1.5, 0.1, 1.4], np.float32)
    v = P.Viewer(P.sphere_tree(basis_dim=1, depth=3, device="cpu"),
                 camera=cam, device="cpu")
    log_dir = str(tmp_path / "prof")
    with PPR.trace(log_dir) as prof:
        for _ in range(2):
            with PPR.annotate("viewer_frame"):
                v.render()
    assert prof is not None
    files = os.listdir(log_dir)
    assert files == [f"trace.{os.getpid()}.json"]
    with open(os.path.join(log_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "viewer_frame" in names
    assert sum(e.get("name") == "viewer_frame" for e in events) == 2
    assert any(str(n).startswith("aten::") for n in names)
