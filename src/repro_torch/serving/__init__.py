"""Multi-model serving (port of ``repro.serving``, dense, ssm and hybrid, single device)."""
from repro_torch.serving.engine import SERVABLE_FAMILIES, MultiModelServer
from repro_torch.serving.scheduler import Request, Result

__all__ = ["MultiModelServer", "Request", "Result", "SERVABLE_FAMILIES"]
