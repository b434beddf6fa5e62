"""Kernels launched in a profiled round over the optimizer steps it
computed, padding included (memory copies and sets left out)."""


def read(ctx):
    if ctx.trace is None or ctx.trace.launches() == 0:
        return None
    return ctx.trace.launches() / ctx.steps_per_round
