"""viewer_host_ms.<mix>: the host clock from each Viewer.render call to
its return, a frame at a time, averaged over the window's frames or poses
(the enqueue, and any read the Viewer makes inside the call)."""


def read(ctx):
    s = ctx.spans.get("viewer.render")
    if not s:
        return None
    return sum(s) * 1e3 / len(s)
