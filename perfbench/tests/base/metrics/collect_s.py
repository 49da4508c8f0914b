"""collect_s: a fixture reader of ``ctx.device_ops_s``: the window's
device seconds of the guided collect's kernel."""


def read(ctx):
    s = sum(v for n, v in ctx.device_ops_s.items()
            if n.startswith("mnv::collect_kernel"))
    return s or None
