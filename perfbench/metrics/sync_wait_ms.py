"""sync_wait_ms.<mix>: host ms a frame or pose inside the program's
``sync.*`` spans: each a read that waits on the card (the sync policy's
flags, a CDF, the escalation loop's overflow count, a fetched frame).  The
numerator also holds the window's settle frames, as
``rebuilds_per_pose.orbit`` does."""

from perfbench import program_spans


def read(ctx):
    rec = program_spans.recorded()
    if rec is None or not ctx.window.units:
        return None
    wait = sum(program_spans.seconds(s) for s in rec[0]
               if s.name.startswith("sync."))
    return wait * 1e3 / ctx.window.units
