"""Readers of the program's spans in the window's rounds (``ctx.spans``:
``MetricsLogger.pop_spans`` after each round; ``time_<name>`` host
seconds, ``device_<name>`` device-clock seconds, ``calls_<name>``)."""


def per_step_ms(ctx, key: str):
    """``key`` summed over the window's rounds, in ms per optimizer step
    (the rounds' summed ``calls_step``).  Silent where a round lacks the
    spans, or where the steps they counted are not the ones the cell
    computes."""
    if not ctx.spans or any(key not in s or "calls_step" not in s for s in ctx.spans):
        return None
    steps = sum(s["calls_step"] for s in ctx.spans)
    if steps != len(ctx.spans) * ctx.steps_per_round:
        return None
    return 1e3 * sum(s[key] for s in ctx.spans) / steps
