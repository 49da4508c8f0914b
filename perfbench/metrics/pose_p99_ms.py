"""pose_p99_ms: the 99th percentile over every pose of the window; a
pose runs from the drag's move to its frame's completion (synchronised
per pose).  The tail a dragging user feels: the poses whose frame the
sync policy redoes."""

import numpy as np


def read(ctx):
    w = ctx.window
    if not w.latencies:
        return None
    return float(np.percentile(np.asarray(w.latencies) * 1e3, 99))
