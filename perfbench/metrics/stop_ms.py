"""stop_ms: the median guided stop of the window; a stop runs from the
drag's release (``end_drag()``) to the completion of the guided frame
that follows (the collect, the model's query, the composite),
synchronised.  The wait for the model's colours after a drag; p50-p97
of the window go to standard error."""

import statistics


def read(ctx):
    w = ctx.window
    if not w.latencies:
        return None
    return statistics.median(w.latencies) * 1e3
