"""Serving launcher (port of ``repro.launch.serve``, dense, moe, ssm,
hybrid, vlm and audio families; tensor parallelism for dense, moe, ssm,
hybrid and vlm; the data axis for all six: audio serves on Dx1 meshes,
a model axis raises for it).

Initialises M "fine-tuned" instances as M random initialisations from a
seed, merges them (the paper's offline merge step, timed), and serves a
synthetic request mix from per-instance queues through the merged
program.  Runs on the CUDA device unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-1.3b \\
      --smoke --device cpu --decode-steps 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \\
      --smoke --device cpu --decode-steps 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \\
      --smoke --device cpu --decode-steps 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-26b \\
      --smoke --device cpu --decode-steps 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small \\
      --smoke --device cpu --decode-steps 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-26b \\
      --smoke --device cpu --mesh-shape 1x2
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
      --smoke --device cpu --mesh-shape 1x2
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \\
      --smoke --device cpu --mesh-shape 1x2
  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \\
      --smoke --device cpu --mesh-shape 1x2
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-1.3b \\
      --smoke --device cpu --mesh-shape 1x2
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small \\
      --smoke --device cpu --mesh-shape 2x1
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
      --smoke --device cpu --mesh-shape 2x2

``--mesh-shape DxT`` serves on a (data=D, model=T) mesh of D*T ranks,
one process each (``launch/mesh.py`` says which backend and why): tensor
parallelism over each group of T, the grid's instance rows (or slots)
split over the D groups.  Every rank serves the same requests, rank 0
prints, and the CLI checks that every rank's streams are identical.
Hybrid archs raise ``--max-context`` to the meta tokens plus the SWA
window plus ``--max-new``, as the reference's CLI does; vlm archs raise
it to the image patches plus the longest prompt plus ``--max-new``.

The serving periphery, on one device (``--mesh-shape 1x1``; on a mesh
these flags raise, the SLO flags excepted):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --smoke --device cpu --stream --fault-plan \
      '{"faults": [{"site": "decode", "kind": "raise", "at_call": 3}]}'
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --smoke --device cpu --trace-out trace.json --account \
      --slo-ttft-ms 500 --slo-itl-ms 50
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --smoke --device cpu --http 8000

``--stream`` drives the request mix through the ``AsyncEngine`` as
concurrent clients (tokens print as they land); ``--http PORT`` serves
``POST /v1/completions`` (SSE with ``"stream": true``), ``GET /metrics``,
``/healthz``, ``/v1/slo``, ``/debug/trace`` and ``/debug/flight`` until
Ctrl-C.  ``--fault-plan`` arms a deterministic fault plan (a JSON
literal or file); with ``--stream`` / ``--http`` a ``Supervisor``
recovers from it (``--watchdog-ms``, ``--max-restarts``).
``--trace-out`` writes a Chrome trace of the run, ``--account`` prints
the per-tenant ledger, ``--flight-dir`` arms the flight recorder.
"""
from __future__ import annotations

import argparse
import asyncio
import gc
import json
import time
from collections import Counter

import numpy as np
import torch

from repro_torch import api
from repro_torch.configs import registry
from repro_torch.kernels import ops
from repro_torch.launch import mesh
from repro_torch.models import hybrid as H
from repro_torch.models.common import merge_drawn
from repro_torch.models.shardings import data_rows, moe_cut, refuse_family, vlm_cut
from repro_torch.serving import (AsyncEngine, FaultInjector, FlightRecorder,
                                 MultiModelServer, Request, SLOConfig, Supervisor,
                                 start_http_server)
from repro_torch.serving.scheduler import POLICIES

# flags of the periphery that serves on one device only
ONE_DEVICE_FLAGS = ("stream", "http", "max_queue", "fault_plan", "watchdog_ms",
                    "trace_out", "account", "flight_dir")


# families whose ``init`` takes a generator an instance and draws the
# merged model in place, a layer at a time (``models.common.draw_leaf``)
IN_PLACE = ("moe", "vlm", "audio")
# families whose mesh ranks draw only their model shard (``cut``)
CUTS = {"moe": moe_cut, "vlm": vlm_cut}


def random_merged(cfg, seed: int, device, on_host: bool = False, rows=None, cut=None):
    """M "fine-tuned" instances as M random initialisations (instance i
    seeded ``seed * 1000 + i`` on ``device``), merged; ``rows`` (a range)
    draws and merges only those instances, the same weights.

    moe, vlm and audio (``IN_PLACE``) draw every instance straight into
    the merged leaves on ``device``, a layer at a time, so nothing but the
    merged model and one layer of one leaf is ever held (olmoe-1b-7b at M
    = 4: 57 GB); ``cut`` (``shardings.moe_cut`` or ``vlm_cut``) keeps
    only a mesh rank's slice of each drawn layer, so a rank holds only its
    shard.  The other
    families draw each instance whole and copy it into the merged leaves
    at once (``models.common.merge_drawn``); ``on_host`` merges them on
    the CPU (a mesh rank then moves only its shard to the card).  Returns
    (merged params, merge seconds: the copies into the merged leaves, None
    for an in-place draw, the device the merge ran on)."""
    rows = range(cfg.num_instances) if rows is None else rows
    if cfg.family in IN_PLACE:
        gens = [torch.Generator(device=device).manual_seed(seed * 1000 + r) for r in rows]
        kw = {} if cut is None else {"cut": cut}
        with torch.no_grad():
            merged = api.family_module(cfg).init(cfg.with_(num_instances=len(rows)), gens,
                                                 device, **kw)
        return merged, None, device
    where = torch.device("cpu") if on_host else device
    one = cfg.with_(num_instances=1)
    draw_s = 0.0

    def sync():
        if where.type == "cuda":
            torch.cuda.synchronize(where)

    def draw(j):
        nonlocal draw_s
        sync()                          # the copies so far count as merge time
        t = time.perf_counter()
        with torch.inference_mode():
            p = api.init(one, torch.Generator(device=device).manual_seed(seed * 1000 + rows[j]),
                         device).to(where)
        sync()
        draw_s += time.perf_counter() - t
        return p

    # merged outside inference mode: a parameter made in it stays an
    # inference tensor, and once ``.to(device)`` swaps its data no view of
    # it can be taken
    t0 = time.perf_counter()
    with torch.no_grad():
        merged = merge_drawn(draw, len(rows))
    sync()
    return merged, time.perf_counter() - t0 - draw_s, where


def drain(server, reqs) -> list:
    """Submit ``reqs`` and step the server until it is idle."""
    for r in reqs:
        server.submit(r)
    return server.run_until_drained()


def serve(cfg, params, reqs, *, device, tp=None, run=drain, **server_kw) -> dict:
    """Serve ``reqs`` to the end on a new server, through ``run(server,
    reqs)`` (the synchronous drain by default).  Every launch counter,
    the mesh handle's collective counts and the card's peak memory are
    reset just before the requests are submitted and read after the
    drain.  ``params`` is a whole merged
    model, or an int seed of :func:`random_merged` (drawn on ``device``;
    on a mesh only the instance rows of the rank's data group: merged on
    the CPU, the server moving only the rank's shard, or for moe and vlm
    drawn as the rank's shard on ``device``)."""
    t_setup = time.perf_counter()
    merge_s = merge_dev = None
    first, sharded = 0, False
    if isinstance(params, int):
        rows = data_rows(cfg.num_instances, server_kw["slots_per_instance"],
                         None if tp is None else tp.data)
        first = rows.m0
        local = cfg.with_(num_instances=rows.m)
        sharded = cfg.family in CUTS and tp is not None and tp.size > 1
        cut = CUTS[cfg.family](local, tp.rank, tp.size) if sharded else None
        params, merge_s, merge_dev = random_merged(cfg, params, device, on_host=tp is not None,
                                                   rows=range(rows.m0, rows.m0 + rows.m), cut=cut)
    host_bytes = sum(p.numel() * p.element_size() for p in params.parameters()
                     if p.device.type == "cpu")
    server = MultiModelServer(cfg, params, device=device, tp=tp, first_instance=first,
                              sharded=sharded, **server_kw)
    del params
    setup_peak = None
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_setup
    ops.reset_launches()
    if tp is not None:
        tp.calls.clear()
    t0 = time.perf_counter()
    results = run(server, reqs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    serve_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    return {"server": server, "results": results, "wall_s": wall, "setup_s": setup_s,
            "merge_s": merge_s,
            "merge_device": merge_dev, "launches": ops.launches(), "host_param_bytes": host_bytes,
            "collectives": None if tp is None else dict(tp.calls),
            "setup_peak_bytes": setup_peak, "serve_peak_bytes": serve_peak,
            "snapshot": server.metrics.snapshot()}


def serve_rank(tp, cfg, params, reqs, server_kw, verbose: bool = False) -> dict:
    """One rank of a serve on a mesh (a target of ``mesh.spawn``).
    Returns what the rank saw: its streams, launch counts, the model
    group's collectives by method, metrics
    snapshot, wall and setup times, device, backend, the peak memory allocated on
    its card while serving and, apart, from the process start to the end
    of the setup (which draws each instance in f32 on the card; both None
    on the CPU), and the host bytes of the params it was given; global
    rank 0 prints the report when ``verbose``."""
    out = serve(cfg, params, reqs, device=tp.device, tp=tp, **server_kw)
    if verbose and tp.rank == 0 and tp.data.rank == 0:
        report(out, cfg, tp)
    server = out.pop("server")
    seen = {"prefill_calls": server.prefill.device_calls, "decode_blocks": server.steps}
    # the server holds a reference cycle (its step is a bound method): free
    # its weights and caches now, before the rank's next call draws its own
    del server
    gc.collect()
    if tp.device.type == "cuda":
        torch.cuda.empty_cache()
    return {"streams": {r.request_id: r.tokens for r in out["results"]},
            "statuses": [r.status for r in out["results"]],
            "launches": out["launches"], "collectives": out["collectives"],
            "snapshot": out["snapshot"],
            "wall_s": out["wall_s"], "setup_s": out["setup_s"], "device": str(tp.device),
            "backend": tp.backend,
            "peak_gib": (None if out["serve_peak_bytes"] is None
                         else out["serve_peak_bytes"] / 2 ** 30),
            "setup_peak_gib": (None if out["setup_peak_bytes"] is None
                               else out["setup_peak_bytes"] / 2 ** 30),
            "host_param_gib": out["host_param_bytes"] / 2 ** 30, **seen}


def report(out, cfg, tp=None) -> None:
    server, results, dt = out["server"], out["results"], out["wall_s"]
    if out["merge_s"] is not None:
        print(f"NetFuse merge of {server.rows.m} instances: {out['merge_s'] * 1e3:.1f} ms "
              f"on {out['merge_device']}")
    if tp is not None:
        rows = server.rows
        print(f"mesh {tp.data.size}x{tp.size} (data x model), {tp.backend}; rank 0 on "
              f"{tp.device}; data split {rows.split}: rank 0 holds instances "
              f"[{rows.m0}, {rows.m0 + rows.m}) x slots [{rows.b0}, {rows.b0 + rows.b})")
    toks = sum(len(r.tokens) for r in results)
    snap = out["snapshot"]
    statuses = Counter(r.status for r in results)
    if set(statuses) - {"ok"}:
        # failed, shed or unavailable requests (a fault plan's retry budget
        # spent, a quarantined instance) are not a smaller clean run
        print("requests by status: " + ", ".join(f"{k} {v}" for k, v in sorted(statuses.items())))
    print(f"served {len(results)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s, {snap['decode_steps']} decode steps in "
          f"{server.steps} blocks @ K={server.decode_steps}, "
          f"{snap['tokens_per_device_call']:.1f} tok/block)")
    print(f"chunked prefill: chunk={server.prefill.chunk}, "
          f"{server.prefill.device_calls} chunk calls for "
          f"{server.prefill.admitted} admissions")
    print(server.metrics.format_table())
    for r in sorted(results, key=lambda r: r.request_id)[:4]:
        print(f"  req {r.request_id} (instance {r.instance}): {r.tokens[:8]}...")


def _supervise(engine, args):
    """A started Supervisor where the run asked for recovery
    (``--fault-plan`` or ``--watchdog-ms``), else None."""
    if not (args.fault_plan or args.watchdog_ms > 0):
        return None
    sup = Supervisor(engine, watchdog_s=args.watchdog_ms / 1e3 if args.watchdog_ms > 0 else None,
                     max_restarts=args.max_restarts, seed=args.seed)
    sup.start()
    return sup


def _print_recovery(sup) -> None:
    if sup is None:
        return
    s = sup.snapshot()
    print(f"supervision: {s['driver_restarts']} restart(s), "
          f"{s['watchdog_timeouts']} watchdog timeout(s), "
          f"{s['request_retries']} request requeue(s), "
          f"{s['tokens_replayed']} token(s) replayed"
          + (f", last recovery {s['last_recovery_s'] * 1e3:.1f} ms"
             if s["last_recovery_s"] is not None else ""))


def _print_obs(server) -> None:
    """The per-tenant ledger and the SLO table, where either is on."""
    acct = server.accounting
    if acct.enabled or acct.settled_s > 0:
        print(acct.format_table())
    rep = server.metrics.slo_report()
    if rep.get("configured"):
        c = rep["config"]
        lines = [f"SLO (target {c['target']:.0%}"
                 + (f", ttft<={c['ttft_ms']:g}ms" if c["ttft_ms"] else "")
                 + (f", itl<={c['itl_ms']:g}ms" if c["itl_ms"] else "") + ")"]
        for i, inst in enumerate(rep["instances"]):
            objs = "  ".join(f"{name}: {o['bad_frac']:.2%} bad, burn {o['burn_rate']:.2f}, "
                             f"budget {o['budget_remaining']:.0%}"
                             for name, o in inst["objectives"].items())
            lines.append(f"  inst {i} [{inst['state']:>8}]  {objs}")
        print("\n".join(lines))


def stream_run(args):
    """``run`` for :func:`serve`: one async client per request through the
    ``AsyncEngine``, tokens printed as they land (supervised where the
    run asked for recovery)."""
    def run(server, reqs):
        async def go():
            engine = AsyncEngine(server, max_queue_depth=args.max_queue)
            sup = _supervise(engine, args)

            async def client(r):
                stream = await engine.submit(r)
                async for tok in stream:
                    print(f"  req {stream.request_id:>3} inst {r.instance} +{tok}")
                return await stream.result()

            results = await asyncio.gather(*(client(r) for r in reqs))
            await engine.aclose()
            _print_recovery(sup)
            return list(results)
        return asyncio.run(go())
    return run


def http_run(args):
    """``run`` for :func:`serve`: serve HTTP on ``--http PORT`` until
    Ctrl-C, then drain; the request mix is not used."""
    def run(server, _reqs):
        async def go():
            engine = AsyncEngine(server, max_queue_depth=args.max_queue)
            sup = _supervise(engine, args)
            http = await start_http_server(engine, port=args.http)
            host, port = http.sockets[0].getsockname()[:2]
            print(f"serving HTTP on {host}:{port}: POST /v1/completions "
                  f"(model-0..model-{server.m - 1}, prompt = token ids, \"stream\": true "
                  f"for SSE), GET /metrics, /healthz, /v1/slo, /debug/trace", flush=True)
            try:
                async with http:
                    await http.serve_forever()
            except asyncio.CancelledError:
                pass
            finally:
                http.close()
                await http.wait_closed()
                await engine.aclose()
                _print_recovery(sup)
        try:
            asyncio.run(go())
        except KeyboardInterrupt:
            pass
        return []
    return run


def observed(run, args):
    """``run`` with the periphery flags applied: accounting and tracing
    started, the fault plan armed, the trace written at the end."""
    def go(server, reqs):
        if args.account:
            server.accounting.start()
        if args.trace_out:
            server.tracer.start()
        if args.fault_plan:
            server.faults.arm()
        results = run(server, reqs)
        if args.trace_out:
            server.tracer.stop()
            chrome = server.tracer.export_chrome()
            summ = server.tracer.summary()
            with open(args.trace_out, "w") as f:
                json.dump(chrome, f)
            do = summ["dispatch_overhead_ms"]
            print(f"wrote {args.trace_out}: {len(chrome['traceEvents'])} events"
                  + ("" if do is None else
                     f", dispatch gap p50/p95 {do['p50']:.2f}/{do['p95']:.2f} ms, "
                     f"grid occupancy {summ['mean_grid_occupancy']:.2f}"))
        return results
    return go


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(registry.PORTED))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; no card and no --device raises)")
    ap.add_argument("--num-instances", type=int, default=4)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-context", type=int, default=128)
    ap.add_argument("--policy", choices=sorted(POLICIES), default="fifo")
    ap.add_argument("--chunk", type=int, default=32,
                    help="prefill chunk size (tokens per admission call)")
    ap.add_argument("--chunk-budget", type=int, default=4,
                    help="max prefill chunk calls interleaved per engine step")
    ap.add_argument("--lanes", type=int, default=4,
                    help="concurrent prefill lanes (requests mid-admission)")
    ap.add_argument("--decode-steps", type=int, default=1, metavar="K",
                    help="K decode+sample steps per dispatched block")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh-shape", default="1x1", metavar="DxT",
                    help="serve under a (data=D, model=T) mesh, one process per rank")
    ap.add_argument("--stream", action="store_true",
                    help="drive the requests through the AsyncEngine as concurrent clients")
    ap.add_argument("--http", type=int, default=0, metavar="PORT",
                    help="serve HTTP on PORT until Ctrl-C (0: off)")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="per-instance queue bound of the async paths (0: unbounded)")
    ap.add_argument("--fault-plan", default=None, metavar="JSON",
                    help='deterministic fault plan, a JSON literal or file: {"seed": 0, '
                         '"faults": [{"site": "decode", "kind": "raise", "at_call": 3}]}; '
                         "with --stream / --http a Supervisor recovers")
    ap.add_argument("--watchdog-ms", type=float, default=0.0,
                    help="per-step watchdog of the async paths (0: none)")
    ap.add_argument("--max-restarts", type=int, default=5,
                    help="supervisor restart budget before giving up")
    ap.add_argument("--trace-out", default=None, metavar="TRACE.json",
                    help="capture a step trace of the run as Chrome-trace JSON")
    ap.add_argument("--slo-ttft-ms", type=float, default=0.0,
                    help="TTFT objective threshold (0: none)")
    ap.add_argument("--slo-itl-ms", type=float, default=0.0,
                    help="ITL objective threshold (0: none)")
    ap.add_argument("--slo-target", type=float, default=0.99,
                    help="fraction of samples that must meet each objective")
    ap.add_argument("--account", action="store_true",
                    help="per-tenant device-time ledger, printed at the end")
    ap.add_argument("--flight-dir", default=None, metavar="DIR",
                    help="flight recorder: dump JSON on crash, watchdog or quarantine")
    ap.add_argument("--no-tail-fold", action="store_true",
                    help="single-token tail calls instead of a padded final chunk")
    args = ap.parse_args(argv)

    d, t = mesh.parse_mesh_shape(args.mesh_shape)
    used = [f"--{f.replace('_', '-')}" for f in ONE_DEVICE_FLAGS if getattr(args, f)]
    if d * t > 1 and used:
        raise NotImplementedError(f"{', '.join(used)}: the serving periphery serves on one "
                                  f"device; --mesh-shape {args.mesh_shape} is not ported for it")
    device = api.resolve_device(args.device)
    base = registry.get_smoke_config(args.arch) if args.smoke else registry.get_config(args.arch)
    # the engine refuses a model axis for audio too, but inside the spawned
    # ranks, after each drew its weights, and ``mesh.spawn`` reports a
    # rank's failure as a RuntimeError: refuse before the spawn, by name
    if t > 1:
        refuse_family(base)
    max_context = args.max_context
    need, why = 0, ""
    if base.family == "hybrid":
        need, why = H.min_serving_context(base, args.max_new), "hybrid meta tokens + SWA ring"
    elif base.family == "vlm":
        need, why = base.num_image_patches + 8 + args.max_new, "image patches + prompt + new"
    if max_context < need:
        print(f"raising --max-context {max_context} -> {need} ({why})")
        max_context = need
    cfg = base.with_(num_instances=args.num_instances)
    rng = np.random.default_rng(args.seed)
    reqs = [
        Request(instance=i % cfg.num_instances,
                prompt=rng.integers(1, cfg.vocab_size, size=rng.integers(2, 8)).tolist(),
                max_new_tokens=args.max_new)
        for i in range(args.requests)
    ]
    server_kw = dict(slots_per_instance=args.slots, max_context=max_context,
                     temperature=args.temperature, top_k=args.top_k, seed=args.seed,
                     scheduler=args.policy, prefill_chunk=args.chunk,
                     prefill_lanes=args.lanes, chunk_budget=args.chunk_budget,
                     decode_steps=args.decode_steps, tail_fold=not args.no_tail_fold)
    if args.slo_ttft_ms > 0 or args.slo_itl_ms > 0:
        server_kw["slo"] = SLOConfig(ttft_ms=args.slo_ttft_ms or None,
                                     itl_ms=args.slo_itl_ms or None, target=args.slo_target)
    print(f"policy={args.policy}, mesh {d}x{t}")
    if d * t == 1:
        if args.fault_plan:
            server_kw["faults"] = FaultInjector.from_json(args.fault_plan)
            print(f"fault plan: {len(server_kw['faults'].plan)} spec(s), "
                  f"seed {server_kw['faults'].seed}")
        if args.flight_dir:
            server_kw["flight"] = FlightRecorder(args.flight_dir)
        run = http_run(args) if args.http else stream_run(args) if args.stream else drain
        out = serve(cfg, args.seed, reqs, device=device, run=observed(run, args), **server_kw)
        report(out, cfg)
        _print_obs(out["server"])
        return
    print(mesh.describe(d * t, device.type))
    outs = mesh.spawn(serve_rank, t, cfg, args.seed, reqs, server_kw, True,
                      device=device.type, data=d)
    if any(o["streams"] != outs[0]["streams"] for o in outs):
        raise RuntimeError("the ranks' token streams differ")
    print(f"{d * t} ranks on {[o['device'] for o in outs]}: streams identical")


if __name__ == "__main__":
    main()
