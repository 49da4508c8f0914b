"""march_roofline.<mix>: kernel A's (csrc/march.cu) least time over its
time.  The least time is the larger of its bytes at 3.35 TB/s and its
operations at 67 TFLOP/s (roofline.march_work, from the window's launches,
steps and shaded samples); its time is the sum of the profiler's
records of ``mnv::march_kernel`` in the traced window."""

from perfbench import roofline


def read(ctx):
    t = ctx.totals
    if not t.get("march_s"):
        return None
    cols, use_sh, data_dim = t["march_dims"]
    n_bytes, n_ops = roofline.march_work(
        t["march_rays"], cols, use_sh, data_dim, t["march_steps"],
        t["march_shaded"])
    return 100.0 * roofline.least_seconds(n_bytes, n_ops) / t["march_s"]
