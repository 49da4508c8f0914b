"""mlp_roofline.<mix>: the model's products' least time over their time.
The least time is the larger of their operations at 67 TFLOP/s and their
bytes at 3.35 TB/s (``roofline.least_seconds``): the program's
``mlp_rows`` counter times the operations and the bytes a row of the
configuration's model (``models/<arch>.py``'s ``work``: 2 per
multiply-add; each product's f32 input and output row), plus the weights
once a query (``mlp_queries``).  The time is the window's seconds of the device operations whose
name holds ``gemm`` or ``gemv`` (cuBLAS's matrix products) in
``ctx.device_ops_s``."""

from perfbench import program_spans, registry, roofline


def gemm_seconds(device_ops_s: dict) -> float:
    return sum(s for n, s in device_ops_s.items()
               if "gemm" in n.lower() or "gemv" in n.lower())


def read(ctx):
    rec = program_spans.recorded()
    spec = ctx.cfg.get("model")
    if rec is None or spec is None or "mlp_rows" not in rec[1]:
        return None
    t = gemm_seconds(ctx.device_ops_s)
    if not t:
        return None
    ops, row_bytes, weight_bytes = registry.model_module(
        spec["arch"]).work(spec)
    rows = rec[1]["mlp_rows"]
    n_bytes = rows * row_bytes + rec[1].get("mlp_queries", 1) * weight_bytes
    least = roofline.least_seconds(n_bytes, rows * ops)
    return 100.0 * least / t
