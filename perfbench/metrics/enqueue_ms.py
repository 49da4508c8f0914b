"""enqueue_ms.<mix>: host ms a frame or pose in the program's four
``frame.*`` spans (raygen, setup, march, assemble: the queueing of one
frame's work on the card), less the ``sync.*`` spans inside them.  The
numerator also holds the window's settle frames (each view's, each drag
episode's), as ``rebuilds_per_pose.orbit`` does."""

from perfbench import program_spans


def read(ctx):
    rec = program_spans.recorded()
    if rec is None or not ctx.window.units:
        return None
    return program_spans.enqueue_s(rec[0]) * 1e3 / ctx.window.units
