"""Prometheus text exposition for ``ServerMetrics.snapshot()`` (port of
``repro.serving.obs.prometheus``).

``GET /metrics`` negotiates on the ``Accept`` header: JSON stays the
default (every existing client keeps working), but ``text/plain`` or
``application/openmetrics-text`` answers Prometheus exposition format
0.0.4 — ``# HELP`` / ``# TYPE`` comments, one ``name{labels} value``
sample per line — rendered straight from the same snapshot dict, so the
two representations can never disagree.

No prometheus_client dependency (the container bakes none): the format
is lines of text with three escape sequences in label values
(``\\`` -> ``\\\\``, ``"`` -> ``\\"``, newline -> ``\\n``), which
:func:`escape_label` implements and the tests' parser round-trips.
"""
from __future__ import annotations

import math

PREFIX = "repro"

# (snapshot key, metric name suffix, type, help)
_ENGINE_FIELDS = (
    ("generated_tokens", "generated_tokens_total", "counter",
     "Tokens generated across all instances"),
    ("decode_steps", "decode_steps_total", "counter",
     "Fused (M,B)-grid decode+sample scan steps"),
    ("decode_device_calls", "decode_device_calls_total", "counter",
     "Fused decode device calls (K-step blocks; == steps at K=1)"),
    ("tokens_per_device_call", "tokens_per_device_call", "gauge",
     "Real tokens emitted per fused decode device call (K*occupancy)"),
    ("decode_dispatch_ms_per_token", "decode_dispatch_ms_per_token", "gauge",
     "Host dispatch ms per decoded token (amortized ~K-fold by blocks)"),
    ("prefill_batches", "prefill_chunk_calls_total", "counter",
     "Prefill chunk/tail device calls"),
    ("prefill_tokens", "prefill_tokens_total", "counter",
     "Real (non-padded) prompt positions prefilled"),
    ("device_calls", "device_calls_total", "counter",
     "All device calls: decode steps + prefill chunks + slot scatters"),
    ("scatter_calls", "scatter_calls_total", "counter",
     "Prefill-lane -> grid-slot scatter device calls"),
    ("prefill_compiled_shapes", "prefill_compiled_shapes", "gauge",
     "Distinct compiled prefill shapes (a rise mid-run is a recompile)"),
    ("cancelled", "cancelled_total", "counter",
     "Requests cancelled/expired across all instances"),
    ("rejected", "rejected_total", "counter",
     "Requests rejected at submit-time validation"),
    ("failed", "failed_total", "counter",
     "Requests terminally failed by a contained fault (NaN guard, "
     "prefill/scatter error)"),
    ("shed", "shed_total", "counter",
     "Requests shed by overload brownout (queued past the age bound)"),
    ("requeued", "requeued_total", "counter",
     "Requests requeued by crash recovery (replayed under the same id)"),
    ("replayed_tokens", "tokens_replayed_total", "counter",
     "Tokens regenerated with emission suppressed after a requeue"),
    ("replay_mismatches", "replay_mismatches_total", "counter",
     "Replayed tokens that differed from the delivered prefix "
     "(must stay 0 under greedy decode)"),
    ("tok_per_s", "tokens_per_second", "gauge",
     "Aggregate generation throughput over the metrics window"),
    ("prefill_tok_per_s", "prefill_tokens_per_second", "gauge",
     "Prefill throughput over settled admission wall time"),
    ("decode_tok_per_s", "decode_tokens_per_second", "gauge",
     "Decode throughput over non-prefill wall time"),
    ("admission_stall_ms", "admission_stall_ms_total", "counter",
     "Wall time decode-ready slots waited on admission chunks"),
    ("wall_s", "window_seconds", "gauge",
     "Age of the metrics window"),
)

_INSTANCE_FIELDS = (
    ("submitted", "instance_submitted_total", "counter"),
    ("admitted", "instance_admitted_total", "counter"),
    ("completed", "instance_completed_total", "counter"),
    ("cancelled", "instance_cancelled_total", "counter"),
    ("rejected", "instance_rejected_total", "counter"),
    ("queue_depth", "instance_queue_depth", "gauge"),
    ("queue_peak", "instance_queue_peak", "gauge"),
    ("prompt_tokens", "instance_prompt_tokens_total", "counter"),
    ("generated_tokens", "instance_generated_tokens_total", "counter"),
    ("tok_per_s", "instance_tokens_per_second", "gauge"),
    ("failed", "instance_failed_total", "counter"),
    ("shed", "instance_shed_total", "counter"),
    ("requeued", "instance_requeued_total", "counter"),
)

# snapshot["resilience"] block (Supervisor counters; zeros when no
# Supervisor is wired, so the rows are always present for scrapers)
_RESILIENCE_FIELDS = (
    ("driver_restarts", "driver_restarts_total",
     "Supervised engine-driver restarts (crash or watchdog)"),
    ("request_retries", "request_retries_total",
     "Request requeues across driver restarts"),
    ("watchdog_timeouts", "watchdog_timeouts_total",
     "Device steps that overran the watchdog deadline"),
    ("tokens_replayed", "supervisor_tokens_replayed_total",
     "Delivered-prefix tokens scheduled for suppressed replay"),
    ("retry_budget_exhausted", "retry_budget_exhausted_total",
     "Requests terminally failed after exhausting the retry budget"),
)

HEALTH_STATES = ("healthy", "degraded", "quarantined", "probation")
SLO_STATES = ("ok", "burning", "violated")

_QUANTILES = (("p50", "0.5"), ("p95", "0.95"), ("p99", "0.99"))


def escape_label(value) -> str:
    """Prometheus label-value escaping: backslash, double quote, newline."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _num(v) -> str:
    if v is None:
        return "NaN"
    v = float(v)
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(v) if not v.is_integer() else str(int(v))


def _sample(name: str, labels: dict, value) -> str:
    if labels:
        body = ",".join(
            f'{k}="{escape_label(v)}"' for k, v in labels.items())
        return f"{PREFIX}_{name}{{{body}}} {_num(value)}"
    return f"{PREFIX}_{name} {_num(value)}"


def render(snapshot: dict, *, extra_labels: dict | None = None) -> str:
    """Render a ``ServerMetrics.snapshot()`` dict as Prometheus text
    exposition (format 0.0.4).  ``extra_labels`` (e.g. mesh geometry)
    attach to every sample."""
    base = dict(extra_labels or {})
    lines: list[str] = []

    def head(name, typ, hlp):
        lines.append(f"# HELP {PREFIX}_{name} {hlp}")
        lines.append(f"# TYPE {PREFIX}_{name} {typ}")

    for key, name, typ, hlp in _ENGINE_FIELDS:
        if key not in snapshot:
            continue
        head(name, typ, hlp)
        lines.append(_sample(name, base, snapshot[key]))

    for block, name in (("ttft_ms", "ttft_milliseconds"),
                        ("itl_ms", "itl_milliseconds")):
        head(name, "summary", f"{block} quantiles over the sample window")
        d = snapshot.get(block)
        for pkey, q in _QUANTILES:
            lines.append(_sample(
                name, {**base, "quantile": q},
                d[pkey] if d is not None else None))

    insts = snapshot.get("instances", ())
    for key, name, typ in _INSTANCE_FIELDS:
        head(name, typ, f"Per-instance {key}")
        for i, st in enumerate(insts):
            lines.append(_sample(name, {**base, "instance": i}, st[key]))
    for block, name in (("ttft_ms", "instance_ttft_milliseconds"),
                        ("itl_ms", "instance_itl_milliseconds")):
        head(name, "summary", f"Per-instance {block} quantiles")
        for i, st in enumerate(insts):
            d = st.get(block)
            for pkey, q in _QUANTILES:
                lines.append(_sample(
                    name, {**base, "instance": i, "quantile": q},
                    d[pkey] if d is not None else None))

    for block, name in (("ttft_hist", "instance_ttft_seconds"),
                        ("itl_hist", "instance_itl_seconds")):
        if not any(st.get(block) for st in insts):
            continue
        head(name, "histogram",
             f"Per-instance {block.split('_')[0]} log-bucketed histogram")
        for i, st in enumerate(insts):
            h = st.get(block)
            if h is None:
                continue
            for le, cum in h["buckets"]:
                lines.append(_sample(
                    f"{name}_bucket",
                    {**base, "instance": i,
                     "le": "+Inf" if math.isinf(le) else _num(le)},
                    cum))
            lines.append(_sample(f"{name}_sum", {**base, "instance": i},
                                 h["sum"]))
            lines.append(_sample(f"{name}_count", {**base, "instance": i},
                                 h["count"]))

    slo = snapshot.get("slo")
    if slo is not None and slo.get("configured"):
        head("slo_burn_rate", "gauge",
             "Recent bad fraction over the allowed SLO error budget "
             "(>1 means the budget is burning)")
        for i, inst in enumerate(slo["instances"]):
            for obj, rep in inst["objectives"].items():
                lines.append(_sample(
                    "slo_burn_rate", {**base, "instance": i, "objective": obj},
                    rep["burn_rate"]))
        head("slo_budget_remaining", "gauge",
             "Fraction of the cumulative SLO error budget still unspent")
        for i, inst in enumerate(slo["instances"]):
            for obj, rep in inst["objectives"].items():
                lines.append(_sample(
                    "slo_budget_remaining",
                    {**base, "instance": i, "objective": obj},
                    rep["budget_remaining"]))
        head("slo_state", "gauge",
             "Per-instance worst objective state; the active state reads 1")
        for i, inst in enumerate(slo["instances"]):
            for state in SLO_STATES:
                lines.append(_sample(
                    "slo_state", {**base, "instance": i, "state": state},
                    1 if inst["state"] == state else 0))

    acct = snapshot.get("accounting")
    if acct is not None:
        head("tenant_device_seconds_total", "counter",
             "Settled device wall seconds attributed to each tenant, "
             "split by account (decode/prefill/scatter/idle)")
        for i, per in sorted(acct["per_tenant"].items(),
                             key=lambda kv: int(kv[0])):
            for account in ("decode_s", "prefill_s", "scatter_s", "idle_s"):
                lines.append(_sample(
                    "tenant_device_seconds_total",
                    {**base, "instance": i,
                     "account": account.removesuffix("_s")},
                    per[account]))
        head("tenant_queue_wait_seconds_total", "counter",
             "Queue wait accumulated by each tenant's admitted requests")
        for i, per in sorted(acct["per_tenant"].items(),
                             key=lambda kv: int(kv[0])):
            lines.append(_sample(
                "tenant_queue_wait_seconds_total", {**base, "instance": i},
                per["queue_wait_s"]))
        head("attribution_conservation_rel_err", "gauge",
             "Relative error |attributed - settled| / settled "
             "(the conservation invariant; must stay < 0.01)")
        lines.append(_sample("attribution_conservation_rel_err", base,
                             acct["conservation_rel_err"]))

    res = snapshot.get("resilience")
    if res is not None:
        for key, name, hlp in _RESILIENCE_FIELDS:
            head(name, "counter", hlp)
            lines.append(_sample(name, base, res.get(key, 0)))
        head("last_recovery_seconds", "gauge",
             "Duration of the most recent driver recovery (NaN if none)")
        lines.append(_sample("last_recovery_seconds", base,
                             res.get("last_recovery_s")))

    health = snapshot.get("health")
    if health is not None:
        head("instances_quarantined", "gauge",
             "Instances currently quarantined (their requests 503)")
        lines.append(_sample("instances_quarantined", base,
                             health["quarantined_now"]))
        head("instance_health_state", "gauge",
             "Per-instance health lifecycle; the active state reads 1")
        for i, st in enumerate(health["states"]):
            for state in HEALTH_STATES:
                lines.append(_sample(
                    "instance_health_state",
                    {**base, "instance": i, "state": state},
                    1 if st == state else 0))

    mesh = snapshot.get("mesh")
    if mesh is not None:
        head("mesh_devices", "gauge", "Devices in the serving mesh")
        lines.append(_sample(
            "mesh_devices",
            {**base, "shape": "x".join(
                f"{k}={v}" for k, v in mesh["shape"].items())},
            mesh["devices"]))
    return "\n".join(lines) + "\n"
