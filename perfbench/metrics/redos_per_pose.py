"""redos_per_pose.<mix>: the program's ``redos`` counter (sync-policy
frames redone after a segment overflowed its budget) over the window's
poses.  The numerator also holds the drag episodes' settle frames, as
``rebuilds_per_pose.orbit`` does."""

from perfbench import program_spans


def read(ctx):
    rec = program_spans.recorded()
    if rec is None or not ctx.window.units:
        return None
    return rec[1].get("redos", 0) / ctx.window.units
