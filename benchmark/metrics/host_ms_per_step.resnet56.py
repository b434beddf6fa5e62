"""Host time of one optimizer step in ms, the local update's ``step``
span (``core/client.py``: building the leaves to the metric sums) over
the window's rounds (``_spans.py``)."""

from benchmark.metrics._spans import per_step_ms


def read(ctx):
    return per_step_ms(ctx, "time_step")
