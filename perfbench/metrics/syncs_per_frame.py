"""syncs_per_frame.<mix>: the program's ``host_syncs`` counter (reads
that wait on the card, one a ``sync.*`` span) over the window's frames or
poses.  The numerator also holds the window's settle frames, as
``rebuilds_per_pose.orbit`` does."""

from perfbench import program_spans


def read(ctx):
    rec = program_spans.recorded()
    if rec is None or not ctx.window.units:
        return None
    return rec[1].get("host_syncs", 0) / ctx.window.units
