"""Telemetry: KPIs accumulated on the device (:class:`MetricsAccumulator`),
flushed to the host once."""
from repro_torch.obs.metrics import MetricsAccumulator, kpi_summary

__all__ = ["MetricsAccumulator", "kpi_summary"]
