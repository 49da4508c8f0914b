"""idle_share.<mix>: the share of the traced window in which no operation
ran on the card: 1 minus the union of the device's operation intervals
over the window, from torch.profiler's timeline."""


def read(ctx):
    tl = ctx.timeline
    if tl is None or not tl[1]:
        return None
    return 100.0 * (1.0 - tl[0] / tl[1])
