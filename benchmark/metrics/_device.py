"""Readers of the profiled round (``benchmark/trace.py``)."""

from benchmark import counts


def idle_share(ctx):
    """Per cent of the profiled round's wall time in which no operation
    ran on the device."""
    tr = ctx.trace
    if tr is None or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def roofline(ctx, kernel: str):
    """Per cent of the kernel's least time (``counts.py``, at the cell's
    shapes, for the launches one round makes) in the kernel's profiled
    time.  Silent where the profiled launches are not the ones counted."""
    tr = ctx.trace
    spec = ctx.family.kernel_bounds(ctx.cfg, ctx.traffic).get(kernel)
    if tr is None or spec is None:
        return None
    secs, _ = tr.kernel_time(*spec["names"])
    _, launches = tr.kernel_time(*spec["launch_names"])
    steps = ctx.steps_per_round
    if secs <= 0 or launches != spec["launches_per_step"] * steps:
        return None
    return 100.0 * spec["bound_ms_per_step"] * steps / (1e3 * secs)


def step_mfu(ctx):
    """Per cent of the card's dense bf16 peak in the model FLOPs of the
    window's real samples or tokens (3× the forward's matmul FLOPs; padding
    not counted) over the window's time."""
    if not ctx.rows:
        return None
    flops = ctx.units * ctx.family.train_flops_per_unit(ctx.cfg, ctx.traffic)
    return 100.0 * flops / ctx.window_s / counts.PEAK_FLOPS["bf16"]
