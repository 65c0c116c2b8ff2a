"""Observability of the port (port of ``repro.serving.obs``; this slice
takes the kernel profiler)."""
