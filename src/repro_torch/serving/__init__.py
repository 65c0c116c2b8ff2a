"""Multi-model serving (port of ``repro.serving``): the engine, its async
and HTTP frontends, observability and resilience."""
from repro_torch.serving.engine import SERVABLE_FAMILIES, MultiModelServer
from repro_torch.serving.frontend import (
    AsyncEngine,
    Backpressure,
    EngineClosed,
    TokenStream,
    start_http_server,
)
from repro_torch.serving.metrics import ServerMetrics
from repro_torch.serving.obs import (
    FlightRecorder,
    LogHistogram,
    SLOConfig,
    TenantAccounting,
    Tracer,
    render_prometheus,
)
from repro_torch.serving.prefill import ChunkedPrefill, PrefillOut
from repro_torch.serving.resilience import (
    BrownoutPolicy,
    FaultInjected,
    FaultInjector,
    FaultSpec,
    HealthMonitor,
    Supervisor,
    WatchdogTimeout,
)
from repro_torch.serving.scheduler import (
    POLICIES,
    FIFOScheduler,
    Request,
    Result,
    RoundRobinScheduler,
    Scheduler,
    TokenBudgetScheduler,
    make_scheduler,
)

__all__ = [
    "AsyncEngine", "Backpressure", "BrownoutPolicy", "ChunkedPrefill", "EngineClosed",
    "FIFOScheduler", "FaultInjected", "FaultInjector", "FaultSpec", "FlightRecorder",
    "HealthMonitor", "LogHistogram", "MultiModelServer", "POLICIES", "PrefillOut",
    "Request", "Result", "RoundRobinScheduler", "SERVABLE_FAMILIES", "SLOConfig",
    "Scheduler", "ServerMetrics", "Supervisor", "TenantAccounting", "TokenBudgetScheduler",
    "TokenStream", "Tracer", "WatchdogTimeout", "make_scheduler", "render_prometheus",
    "start_http_server",
]
