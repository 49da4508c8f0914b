"""mlp_queries_per_stop.<mix>: the program's ``mlp_queries`` counter (each
call of the model's grouped query, ``models/meganerf.py``
``query_grouped``) over the window's stops.  The numerator also holds the
queries of each episode's settle frames, the guided frame at its start
azimuth, as ``redos_per_pose.orbit`` holds the settle frames' redos."""

from perfbench import program_spans


def read(ctx):
    rec = program_spans.recorded()
    if rec is None or not ctx.window.units or "mlp_queries" not in rec[1]:
        return None
    return rec[1]["mlp_queries"] / ctx.window.units
