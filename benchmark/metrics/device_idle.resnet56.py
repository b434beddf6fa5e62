"""Per cent of a profiled round in which the device ran nothing (``_device.py``)."""

from benchmark.metrics._device import idle_share as read  # noqa: F401
