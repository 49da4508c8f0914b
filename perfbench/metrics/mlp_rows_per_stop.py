"""mlp_rows_per_stop.<mix>: the program's ``mlp_rows`` counter (rows the
model's forward computed: the chunked route's cluster-aligned slots, pad
rows included, or every cluster on every row of the all-clusters route)
over the window's stops, the settle frames' queries included as in
``mlp_queries_per_stop``."""

from perfbench import program_spans


def read(ctx):
    rec = program_spans.recorded()
    if rec is None or not ctx.window.units or "mlp_rows" not in rec[1]:
        return None
    return rec[1]["mlp_rows"] / ctx.window.units
