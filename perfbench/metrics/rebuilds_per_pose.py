"""rebuilds_per_pose.<mix>: the calls of order_from_hints,
order_from_hints_device, order_from_packed_device and
render_frame_motion (wraps patched on ops.accel, where the Viewer looks
them up) over the window's poses."""


def read(ctx):
    w = ctx.window
    if not w.units or not ctx.counts:
        return None
    return sum(ctx.counts.values()) / w.units
