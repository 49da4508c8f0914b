"""redo_ms.<mix>: the mean host ms of the program's ``viewer.redo`` spans,
from an overflow's detection to the redo frame's new order: the repair
(the overflowed segments re-marched in place in the frame already
queued), its ``sync.hint_cdf`` read and the new order; a whole hint frame
only where the repair falls back.  0 when the window redid no frame."""

from perfbench import program_spans


def read(ctx):
    rec = program_spans.recorded()
    if rec is None:
        return None
    ms = [program_spans.seconds(s) * 1e3 for s in rec[0]
          if s.name == "viewer.redo"]
    return sum(ms) / len(ms) if ms else 0.0
