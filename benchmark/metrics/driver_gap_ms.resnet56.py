"""Driver overhead per round in ms (``_driver_gap.py``)."""

from benchmark.metrics._driver_gap import driver_gap_ms as read  # noqa: F401
