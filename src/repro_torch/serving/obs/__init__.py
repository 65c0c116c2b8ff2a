"""Observability of the port (port of ``repro.serving.obs``).

``trace``          — ring-buffered step tracer: per-device-call events
                     (dispatch and settled time, dispatch gap, grid
                     occupancy, chunk validity) and request-lifecycle
                     spans; Chrome-trace export and summaries.
``prometheus``     — Prometheus text exposition of
                     ``ServerMetrics.snapshot()``.
``kernel_profile`` — achieved-vs-bound timing of the port's kernels at
                     serving shapes.
``slo``            — log-bucketed latency histograms and per-instance
                     TTFT / ITL / availability objectives with burn rate.
``accounting``     — per-tenant device-time attribution with a
                     conservation invariant, and head-of-line
                     interference.
``flight``         — flight recorder: crash / watchdog / quarantine
                     dumps to JSON.
"""
from repro_torch.serving.obs.accounting import TenantAccounting
from repro_torch.serving.obs.flight import FlightRecorder
from repro_torch.serving.obs.kernel_profile import (
    KERNELS,
    format_table,
    profile_kernel,
    profile_serving_kernels,
    serving_shapes,
    validate_profile,
)
from repro_torch.serving.obs.prometheus import render as render_prometheus
from repro_torch.serving.obs.slo import (
    LogHistogram,
    SLOConfig,
    evaluate_availability,
    evaluate_objective,
    worst_state,
)
from repro_torch.serving.obs.trace import DeviceCallEvent, RequestEvent, Tracer

__all__ = [
    "DeviceCallEvent",
    "FlightRecorder",
    "KERNELS",
    "LogHistogram",
    "RequestEvent",
    "SLOConfig",
    "TenantAccounting",
    "Tracer",
    "evaluate_availability",
    "evaluate_objective",
    "format_table",
    "profile_kernel",
    "profile_serving_kernels",
    "render_prometheus",
    "serving_shapes",
    "validate_profile",
    "worst_state",
]
