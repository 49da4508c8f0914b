"""The program's own spans and counters for one traced window.

``mega_nerf_viewer_tpu_torch.utils.profiling`` records spans and counters
inside the frame path while a profiler session runs.  A ``--trace 1`` run
starts the profiler just before the window and stops it after, so the
recorder holds the window's frames alone: no warm-up, no check frame.  A
version of the program without that recorder gives None, and so does a
window in which it recorded no frame.
"""

# the four spans of one frame's host work in ops/accel.py's _frame_core
FRAME_SPANS = ("frame.raygen", "frame.setup", "frame.march",
               "frame.assemble")


def recorded():
    """(spans, counters) of the window, or None."""
    from mega_nerf_viewer_tpu_torch.utils import profiling
    read = getattr(profiling, "recorded", None)
    if read is None:
        return None
    spans, counters = read()
    if not counters.get("frames"):
        return None
    return spans, counters


def seconds(span) -> float:
    return (span.end_ns - span.start_ns) / 1e9


def enqueue_s(spans) -> float:
    """Host seconds in the frame spans, less the ``sync.*`` spans inside
    them (the host waiting on the card)."""
    by_id = {s.id: s for s in spans}
    total = sum(seconds(s) for s in spans if s.name in FRAME_SPANS)
    for s in spans:
        if not s.name.startswith("sync."):
            continue
        p = by_id.get(s.parent)
        while p is not None:
            if p.name in FRAME_SPANS:
                total -= seconds(s)
                break
            p = by_id.get(p.parent)
    return total
