"""Model FLOPs over the window against the bf16 peak, in per cent (``_device.py``)."""

from benchmark.metrics._device import step_mfu as read  # noqa: F401
