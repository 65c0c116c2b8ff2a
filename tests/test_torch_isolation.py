"""The port stands alone: it imports neither JAX nor the JAX package,
and its entry points refuse to fall back to the CPU without being asked."""
import ast
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _sources():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    return files + sorted((REPO / "benchmarks").glob("torch_*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, f"{path.name} imports {n}"


def test_package_imports_with_jax_blocked():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    raise ImportError("blocked: " + name)
        sys.meta_path.insert(0, Block())
        import repro_torch
        for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
            importlib.import_module(m.name)
        print("ok")
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       cwd=REPO, env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"},
                       timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_entry_points_raise_without_a_card(monkeypatch):
    from repro_torch import api
    from repro_torch.configs import registry
    from repro_torch.serving import MultiModelServer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = registry.get_smoke_config("tinyllama-1.1b")
    params = api.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultiModelServer(cfg, params, slots_per_instance=1, max_context=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.init(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.make_cache(cfg, 1, 1, 16)


def test_kernel_wrapper_rejects_other_devices():
    from repro_torch.kernels import ops

    x = torch.zeros(1, 1, 4, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.logits_sample(x, torch.ones(1, 4, device="meta"),
                          torch.zeros(1, 4, 8, device="meta"))
