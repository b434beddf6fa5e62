"""Host time of a step's functional SGD in ms, the ``optimizer`` span
(``optimizer.update`` and the padding-aware select) over the window's
rounds (``_spans.py``)."""

from benchmark.metrics._spans import per_step_ms


def read(ctx):
    return per_step_ms(ctx, "time_optimizer")
