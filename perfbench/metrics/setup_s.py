"""setup_s: from the process's start to the first timed frame: imports,
the scene file and the kernels (built only in a checkout's first run,
which the check records apart), the tree on the card, the Viewer and its
warm-up frames."""


def read(ctx):
    return ctx.setup_s
