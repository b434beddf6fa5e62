"""Observability (port of ``fedml_tpu/obs``): the telemetry registry
(``telemetry.py``), the message core's counters and trace stamps
(``comm_obs.py``, ``trace_ctx.py``), the flight recorder (``flight.py``),
PyTorch memory gauges (``torch_hooks.py``), and the in-band stats plane
of the cross-device server: mergeable telemetry digests (``digest.py``),
the SLO engine and ``status.json`` (``slo.py``) and the registry of
series names both packages share (``metric_schema.py``)."""

from fedml_tpu_torch.obs.telemetry import (
    Telemetry,
    get_telemetry,
    metric_key,
    parse_metric_key,
)

__all__ = ["Telemetry", "get_telemetry", "metric_key", "parse_metric_key"]
