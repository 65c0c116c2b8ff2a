"""Fault-tolerant serving core (DESIGN.md §6.8; port of
``repro.serving.resilience``): deterministic fault
injection, supervised driver recovery, per-instance health/quarantine,
and overload brownout."""
from repro_torch.serving.resilience.faults import (
    FaultInjected,
    FaultInjector,
    FaultSpec,
)
from repro_torch.serving.resilience.health import HealthMonitor
from repro_torch.serving.resilience.policy import BrownoutPolicy
from repro_torch.serving.resilience.supervisor import Supervisor, WatchdogTimeout

__all__ = [
    "BrownoutPolicy",
    "FaultInjected",
    "FaultInjector",
    "FaultSpec",
    "HealthMonitor",
    "Supervisor",
    "WatchdogTimeout",
]
