"""Device-clock time of a step's attention backwards in ms, every
layer's ``attn_bwd`` span (``ops/flash_attention.py``) summed, over the
window's rounds (``_spans.py``)."""

from benchmark.metrics._spans import per_step_ms


def read(ctx):
    return per_step_ms(ctx, "device_attn_bwd")
