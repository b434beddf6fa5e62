"""The conv kernel's share of its roofline in a profiled round, in per
cent: its least time over its profiled time (``_device.py``)."""

from benchmark.metrics._device import roofline


def read(ctx):
    return roofline(ctx, "conv")
