"""frame_ms: parked frames: the parked time (at each view, from its first
timed frame's start to its last frame's completion, one synchronise at
the end) over the frames issued."""


def read(ctx):
    w = ctx.window
    if not w.units:
        return None
    return w.seconds * 1e3 / w.units
