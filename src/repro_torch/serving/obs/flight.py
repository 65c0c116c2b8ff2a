"""Crash flight recorder (§6.9): the black box for the fused engine
(port of ``repro.serving.obs.flight``).

When the step loop crashes, the watchdog fires, or an instance is
quarantined (§6.8), the post-mortem questions are always the same —
what was in flight, what did the last N device calls look like, how
deep were the queues, which tenant was burning its budget — and by the
time anyone asks, the recovering engine has already moved on.
:class:`FlightRecorder` freezes that state AT the event: one JSON
artifact per incident (``flight-0001.json``, ...) containing the
tracer's last-N events, the full metrics snapshot (which embeds SLO
state and tenant attribution when configured), and the scheduler
depths, plus a bounded in-memory ring served by ``GET /debug/flight``.

Discipline matches the tracer: disabled (no ``--flight-dir``) means the
hook sites read ONE attribute and skip; ``dump`` itself is best-effort
per component (a recorder must never turn an incident into a second
incident), tagging any component that failed to serialize instead of
raising."""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from collections import deque

SCHEMA = "flight/v1"
DEFAULT_LAST_N = 512


class FlightRecorder:
    """Dump-on-incident recorder; enabled iff a directory is set."""

    def __init__(self, directory: str | None = None, *,
                 last_n: int = DEFAULT_LAST_N, keep: int = 4):
        self.directory = directory
        self.enabled = directory is not None
        self.last_n = last_n
        self._seq = 0
        self._lock = threading.Lock()
        # most recent dumps, newest last — the /debug/flight payload
        self.dumps: deque = deque(maxlen=keep)

    def __len__(self) -> int:
        return self._seq

    def _component(self, record: dict, key: str, fn) -> None:
        # best-effort: a failed component becomes {"error": ...}, the
        # rest of the record still lands on disk
        try:
            record[key] = fn()
        except BaseException as e:
            record[key] = {"error": repr(e)}

    def dump(self, reason: str, *, server=None, extra: dict | None = None) -> str | None:
        """Freeze the server's observable state into one artifact.

        Callable from any thread (supervisor loop, engine executor
        thread via the quarantine hook); returns the artifact path, or
        None if the write itself failed."""
        with self._lock:
            self._seq += 1
            seq = self._seq
        record = {"schema": SCHEMA, "seq": seq, "reason": reason,
                  "unix_time": time.time()}
        if extra:
            record["extra"] = dict(extra)
        if server is not None:
            tracer = getattr(server, "tracer", None)
            if tracer is not None:
                self._component(record, "trace_events", lambda: [
                    dict(dataclasses.asdict(ev), event=type(ev).__name__)
                    for ev in tracer._snapshot()[-self.last_n:]])
            metrics = getattr(server, "metrics", None)
            if metrics is not None:
                # embeds "slo" and "accounting" blocks when configured
                self._component(record, "metrics", metrics.snapshot)
            sched = getattr(server, "scheduler", None)
            if sched is not None:
                self._component(record, "queue_depths", sched.depths)
        path = None
        try:
            os.makedirs(self.directory, exist_ok=True)
            path = os.path.join(self.directory, f"flight-{seq:04d}.json")
            with open(path, "w") as f:
                json.dump(record, f, indent=1, default=repr)
        except OSError:
            path = None
        record["path"] = path
        with self._lock:
            self.dumps.append(record)
        return path

    def latest(self) -> list:
        """The in-memory ring, oldest first (``GET /debug/flight``)."""
        with self._lock:
            return list(self.dumps)
