"""Driver overhead per round: window time per round minus the program's
``round`` span (``FedAvgSimulation.run_round``'s round function and its
read-backs), in ms.  What is left is sampling, packing, the history row
and the benchmark's loop."""


def driver_gap_ms(ctx):
    if not ctx.rows:
        return None
    spans = sum(s.get("time_round", 0.0) for s in ctx.spans)
    return 1e3 * (ctx.window_s - spans) / len(ctx.rows)
