"""Async streaming frontend over the fused (M, B) serving engine (port of
``repro.serving.frontend``).

``async_engine`` owns the synchronous ``MultiModelServer`` step loop on
a background driver task and fans tokens out to concurrent per-request
async streams (cancellation, backpressure, TTL, graceful drain);
``http`` serves it over HTTP/SSE with an OpenAI-style completions route
(stdlib ``asyncio.start_server`` — no new dependencies).  DESIGN.md
§6.4.
"""
from repro_torch.serving.frontend.async_engine import (
    AsyncEngine,
    Backpressure,
    EngineClosed,
    TokenStream,
)
from repro_torch.serving.frontend.http import default_model_map, start_http_server

__all__ = [
    "AsyncEngine",
    "Backpressure",
    "EngineClosed",
    "TokenStream",
    "default_model_map",
    "start_http_server",
]
