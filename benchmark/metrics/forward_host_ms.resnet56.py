"""Host time of a step's forward in ms, the ``forward`` span (the casts,
``bundle.apply_train`` and the loss) over the window's rounds
(``_spans.py``)."""

from benchmark.metrics._spans import per_step_ms


def read(ctx):
    return per_step_ms(ctx, "time_forward")
