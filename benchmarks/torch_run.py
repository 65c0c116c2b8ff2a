"""The paper's evaluation on the PyTorch port, one function per table or
figure (the port of ``benchmarks/run.py``, same row names and CSV format).

Paper: NetFuse (Jeong et al. 2020), merging M fine-tuned instances of one
architecture.  On the card the four registered configs run at full width
(resnet50 and resnext50 at 224x224, bert-base and xlnet-base at sequence
128); ``--smoke`` runs the reference's bench-scale models instead.

  fig5  inference time vs #models, bs=1: sequential, concurrent (one CUDA
        stream per instance) and netfuse on resnet / resnext / bert / xlnet
  fig6  BERT batch-size sweep, times relative to netfuse
  fig7  memory per strategy: resident parameter bytes and the peak
        allocated during one call (the card only; XLA's memory_analysis has
        no counterpart here)
  fig8  hybrid strategies on resnext (P rounds of M/P concurrent streams)
  tab_merge   offline merge time vs #models (paper section 4)
  tab_exact   merged outputs == per-instance outputs, max |diff| in f32

Output: ``name,us_per_call,derived`` CSV rows on stdout.  Times are the
median of ``--repeats`` calls after a warm-up, on the host clock around
work that ends in ``torch.cuda.synchronize()``.  Runs on the card unless
``--device cpu`` is given; with no card and no such flag it raises.

  PYTHONPATH=src python benchmarks/torch_run.py [--smoke] [--device cpu] \\
      [--only fig5,tab_exact]

Env, as the reference reads it: REPRO_BENCH_REPEATS (default 30),
REPRO_BENCH_MAX_MODELS (default 16; 32 reaches the paper's headline M).
"""
from __future__ import annotations

import argparse
import functools
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import torch  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core import baselines  # noqa: E402
from repro_torch.models import cnn, encoder  # noqa: E402
from repro_torch.models import common as C  # noqa: E402

REPEATS = int(os.environ.get("REPRO_BENCH_REPEATS", "30"))
MAX_MODELS = int(os.environ.get("REPRO_BENCH_MAX_MODELS", "16"))
SEQ_LEN = 128

ROWS: list[tuple[str, float, str]] = []


def emit(name: str, us: float, derived: str = "") -> None:
    ROWS.append((name, us, derived))
    print(f"{name},{us:.1f},{derived}", flush=True)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timeit(fn, dev: torch.device, repeats: int | None = None) -> float:
    """Median wall time (us) of fn() after a warm-up call."""
    fn()
    _sync(dev)
    ts = []
    for _ in range(repeats or REPEATS):
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts) * 1e6)


# ---------------------------------------------------------------------------
# the four evaluation models
# ---------------------------------------------------------------------------


def bench_models(smoke: bool) -> dict[str, tuple[str, ModelConfig]]:
    """name -> (kind, config): the registered full configs, or with
    ``smoke`` the reference's bench-scale ones (``run.py``)."""
    if not smoke:
        return {"resnet50": ("cnn", registry.get_config("resnet50")),
                "resnext50": ("cnn", registry.get_config("resnext50")),
                "bert": ("enc", registry.get_config("bert-base")),
                "xlnet": ("encx", registry.get_config("xlnet-base"))}
    cnn_cfg = ModelConfig(
        name="resnet-bench", family="cnn", num_layers=0, d_model=0,
        num_heads=0, num_kv_heads=0, d_ff=0, vocab_size=0,
        cnn_stage_blocks=(2, 2), cnn_width=16, cnn_cardinality=1,
        image_size=32, num_classes=16, dtype="float32", param_dtype="float32")
    enc_cfg = ModelConfig(
        name="bert-bench", family="encoder", num_layers=4, d_model=128,
        num_heads=4, num_kv_heads=4, d_ff=512, vocab_size=1024,
        max_target_positions=128, use_layernorm=True, act="gelu",
        dtype="float32", param_dtype="float32")
    return {"resnet50": ("cnn", cnn_cfg),
            "resnext50": ("cnn", cnn_cfg.with_(name="resnext-bench", cnn_cardinality=4)),
            "bert": ("enc", enc_cfg.with_(name="bert-bench")),
            "xlnet": ("encx", enc_cfg.with_(name="xlnet-bench"))}


class Bench:
    """One model: its merged apply, merged parameters of M instances drawn
    from a seed on the device, and inputs."""

    def __init__(self, kind: str, cfg: ModelConfig, dev: torch.device):
        self.kind, self.cfg, self.dev = kind, cfg, dev
        if kind == "cnn":
            self.apply = lambda p, x: torch.stack(cnn.forward(cfg, p, x))   # (M, B, classes)
        else:
            self.apply = lambda p, x: encoder.forward(cfg, p, x, xlnet=kind == "encx")

    def init(self, m: int, seed: int = 0):
        """Merged parameters of m seeded random instances."""
        cfg = self.cfg.with_(num_instances=m)
        g = torch.Generator(device=self.dev).manual_seed(seed)
        with torch.inference_mode():
            if self.kind == "cnn":
                return cnn.init(cfg, g, self.dev)
            return encoder.init(cfg, g, self.dev, xlnet=self.kind == "encx")

    def inputs(self, m: int, b: int, seed: int = 1) -> torch.Tensor:
        g = torch.Generator(device=self.dev).manual_seed(seed)
        if self.kind == "cnn":
            s = self.cfg.image_size
            return torch.randn(m, b, s, s, 3, generator=g, device=self.dev)
        return torch.randint(0, self.cfg.vocab_size, (m, b, SEQ_LEN), generator=g,
                             device=self.dev)


def instances(merged, m: int) -> list:
    """The first m instances of a merged model as M=1 models (views)."""
    return [C.instance_views(merged, i) for i in range(m)]


def strategies(apply_fn, params_list, merged, x, dev, hybrid=()) -> dict:
    """name -> zero-argument callable running one multi-model round through
    ``core.baselines``: params_list holds M=1 models, merged the M-instance
    one, x (M, B, ...).  ``hybrid`` adds ``hybrid_P``: ceil(M/P) rounds of
    P concurrent streams.  netfuse is the premerged call (merging is
    offline, paper section 4; ``tab_merge`` times it)."""
    xs = list(x)
    out = {"sequential": functools.partial(baselines.sequential, apply_fn, params_list, xs),
           "concurrent": functools.partial(baselines.concurrent, apply_fn, params_list, xs)}
    out.update({f"hybrid_{p}": functools.partial(baselines.hybrid, apply_fn, params_list, xs,
                                                 num_concurrent=p) for p in hybrid})
    out["netfuse"] = functools.partial(baselines.netfuse_premerged, apply_fn, merged, x)
    return out


# ---------------------------------------------------------------------------
# figures and tables
# ---------------------------------------------------------------------------


def fig5_inference_time(models, dev, *, counts, repeats=None, hybrid=None) -> dict:
    """Paper Fig. 5: inference time vs number of models (bs=1).  ``hybrid``
    maps a model name to the P values of its hybrid rows.  Returns
    {(model, m, strategy): us}."""
    times = {}
    for name, (kind, cfg) in models.items():
        b = Bench(kind, cfg, dev)
        merged_all = b.init(max(counts))
        x_all = b.inputs(max(counts), 1)
        with torch.inference_mode():
            for m in counts:
                merged = C.instance_views(merged_all, 0, m)
                strat = strategies(b.apply, instances(merged, m), merged, x_all[:m], dev,
                                   hybrid=(hybrid or {}).get(name, ()))
                for s, fn in strat.items():
                    times[name, m, s] = _timeit(fn, dev, repeats)
                    emit(f"fig5/{name}/m{m}/{s}", times[name, m, s])
                emit(f"fig5/{name}/m{m}/speedup_vs_sequential", times[name, m, "netfuse"],
                     f"{times[name, m, 'sequential'] / times[name, m, 'netfuse']:.2f}x")
        del merged_all, x_all
        _free(dev)
    return times


def fig6_batch_sweep(models, dev, *, m=None, repeats=None) -> None:
    """Paper Fig. 6: BERT at batch sizes 1..8, times relative to netfuse."""
    b = Bench(*models["bert"], dev)
    m = m or min(8, MAX_MODELS)
    merged = b.init(m)
    with torch.inference_mode():
        for bs in (1, 2, 4, 8):
            x = b.inputs(m, bs)
            strat = strategies(b.apply, instances(merged, m), merged, x, dev)
            t_fuse = _timeit(strat["netfuse"], dev, repeats)
            for s in ("sequential", "concurrent"):
                t = _timeit(strat[s], dev, repeats)
                emit(f"fig6/bert/bs{bs}/{s}_rel_netfuse", t, f"{t / t_fuse:.2f}x")
            emit(f"fig6/bert/bs{bs}/netfuse", t_fuse, "1.00x")
    del merged
    _free(dev)


def _param_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in C._leaves(C._as_tree(tree)))


def fig7_memory(models, dev, *, counts=None, name="bert") -> dict:
    """Paper Fig. 7: per strategy, the resident parameter bytes and the
    peak allocated during one call (``max_memory_allocated`` after
    ``reset_peak_memory_stats``; the card only).  Returns {(m, strategy):
    (params MB, peak MB)}."""
    b = Bench(*models[name], dev)
    out = {}
    counts = counts or [n for n in (2, 8, 16) if n <= MAX_MODELS]
    for m in counts:
        merged = b.init(m)
        x = b.inputs(m, 1)
        params_mb = _param_bytes(merged) / 1e6
        with torch.inference_mode():
            for s, fn in strategies(b.apply, instances(merged, m), merged, x, dev).items():
                if dev.type != "cuda":
                    emit(f"fig7/{name}/m{m}/{s}_MB", params_mb * 1e3,
                         f"{params_mb:.1f}MB params; peak not measured on the CPU")
                    continue
                fn()
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                fn()
                torch.cuda.synchronize(dev)
                peak_mb = torch.cuda.max_memory_allocated(dev) / 1e6
                out[m, s] = (params_mb, peak_mb)
                emit(f"fig7/{name}/m{m}/{s}_MB", peak_mb * 1e3,
                     f"{peak_mb:.1f}MB peak ({params_mb:.1f}MB params)")
        del merged, x
        _free(dev)
    return out


def fig8_hybrid(models, dev, *, m=None, repeats=None) -> None:
    """Paper Fig. 8: hybrid (P rounds of M/P concurrent streams) on resnext."""
    b = Bench(*models["resnext50"], dev)
    m = m or min(8, MAX_MODELS)
    merged = b.init(m)
    x = b.inputs(m, 1)
    with torch.inference_mode():
        strat = strategies(b.apply, instances(merged, m), merged, x, dev,
                           hybrid=[m // p for p in (2, 4)])
        t_seq = _timeit(strat["sequential"], dev, repeats)
        t_fuse = _timeit(strat["netfuse"], dev, repeats)
        emit(f"fig8/resnext/m{m}/sequential", t_seq, f"{t_seq / t_fuse:.2f}x vs netfuse")
        for p_groups in (2, 4):
            t = _timeit(strat[f"hybrid_{m // p_groups}"], dev, repeats)
            emit(f"fig8/resnext/m{m}/hybrid_{p_groups}groups", t, f"{t / t_fuse:.2f}x vs netfuse")
        emit(f"fig8/resnext/m{m}/netfuse", t_fuse, "1.00x")
    del merged
    _free(dev)


def tab_merge_overhead(models, dev, *, counts=(2, 8, 16, 32)) -> dict:
    """Paper section 4: the offline merge (concatenating M checkpoints)."""
    b = Bench(*models["resnext50"], dev)
    merged_all = b.init(max(counts))
    out = {}
    for m in counts:
        ones = instances(merged_all, m)
        _sync(dev)
        t0 = time.perf_counter()
        merged = C.merge_instances(ones)
        _sync(dev)
        out[m] = (time.perf_counter() - t0) * 1e6
        emit(f"tab_merge/resnext/m{m}", out[m])
        del merged, ones
    del merged_all
    _free(dev)
    return out


def tab_exactness(models, dev, *, m=4, b=2) -> dict:
    """Merged == per-instance, max |diff| (paper: exact), in f32 with
    TF32 off.  Returns {model: (max abs diff, max abs diff relative to the
    largest output magnitude)}."""
    out = {}
    for name, (kind, cfg) in models.items():
        bench = Bench(kind, cfg.with_(dtype="float32", param_dtype="float32"), dev)
        merged = bench.init(m)
        x = bench.inputs(m, b)
        with torch.inference_mode():
            fused = bench.apply(merged, x)
            worst, scale = 0.0, 0.0
            for i, p in enumerate(instances(merged, m)):
                ref = bench.apply(p, x[i:i + 1])[0]
                worst = max(worst, (fused[i] - ref).abs().max().item())
                scale = max(scale, ref.abs().max().item())
        out[name] = (worst, worst / max(scale, 1.0))
        emit(f"tab_exact/{name}/max_abs_diff", 0.0, f"{worst:.2e}")
        emit(f"tab_exact/{name}/max_rel_diff", 0.0, f"{out[name][1]:.2e}")
        del merged, x
        _free(dev)
    return out


def summary() -> dict:
    """The best netfuse speedup over sequential per model (the paper's
    headline), from the fig5 rows."""
    best: dict[str, float] = {}
    for name, _, derived in ROWS:
        if name.startswith("fig5/") and name.endswith("speedup_vs_sequential"):
            model = name.split("/")[1]
            best[model] = max(best.get(model, 0.0), float(derived[:-1]))
    for model, sp in best.items():
        emit(f"summary/{model}/best_netfuse_speedup", 0.0, f"{sp:.2f}x")
    return best


def _free(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's bench-scale models instead of the full configs")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--only", default="fig5,fig6,fig7,fig8,tab_merge,tab_exact",
                    help="comma-separated subset of the figures and tables")
    args = ap.parse_args()
    dev = api.resolve_device(args.device)
    if dev.type == "cuda":
        # f32 means f32: no TF32 in matmuls or convolutions
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    models = bench_models(args.smoke)
    only = set(args.only.split(","))
    counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= MAX_MODELS]
    print("name,us_per_call,derived")
    if "fig5" in only:
        fig5_inference_time(models, dev, counts=counts)
    if "fig6" in only:
        fig6_batch_sweep(models, dev)
    if "fig7" in only:
        fig7_memory(models, dev)
    if "fig8" in only:
        fig8_hybrid(models, dev)
    if "tab_merge" in only:
        tab_merge_overhead(models, dev)
    if "tab_exact" in only:
        tab_exactness(models, dev)
    summary()


if __name__ == "__main__":
    main()
