"""The port's kernel profiler (``serving/obs/kernel_profile.py``) against
the reference's, on the CPU.

The shapes are compared exactly: the profile has to measure what the
reference's profile measures for the same config.  A CPU profile runs the
plain PyTorch versions and must say so (``plain``, backend ``cpu``), so
that no CPU row can pass for a card row.
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest

from repro.configs import registry as jreg
from repro.serving.obs import kernel_profile as jkp
from repro_torch.configs import registry as treg
from repro_torch.kernels import ops
from repro_torch.serving.obs import kernel_profile as tkp

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "xlstm-1.3b", "hymba-1.5b", "qwen1.5-0.5b"])
@pytest.mark.parametrize("full", [False, True])
def test_serving_shapes_match_reference(arch, full):
    get = "get_config" if full else "get_smoke_config"
    jcfg = getattr(jreg, get)(arch).with_(num_instances=4)
    tcfg = getattr(treg, get)(arch).with_(num_instances=4)
    kw = dict(slots=3, max_context=96, chunk=16, prefill_lanes=2)
    assert tkp.serving_shapes(tcfg, **kw) == jkp.serving_shapes(jcfg, **kw)
    assert tkp.serving_shapes(tcfg) == jkp.serving_shapes(jcfg)
    assert tkp.KERNELS == jkp.KERNELS


def test_cpu_profile_is_plain_and_valid():
    """Every kernel at tiny shapes on the CPU: valid figures, marked plain,
    and no kernel launch counted."""
    cfg = treg.get_smoke_config("tinyllama-1.1b").with_(num_instances=2)
    ops.reset_launches()
    rows = tkp.profile_serving_kernels(cfg, slots=2, max_context=32, chunk=8,
                                       prefill_lanes=2, repeats=1, device="cpu")
    bert = treg.get_smoke_config("bert-base").with_(num_instances=2)
    rows += [tkp.profile_kernel(k, dtype=bert.dtype, repeats=1, device="cpu", **s)
             for k, s in tkp.paper_shapes(bert, seq_len=16).items()]
    tkp.validate_profile(rows)
    assert [r["kernel"] for r in rows] == list(tkp.KERNELS) + ["fused_matmul", "group_rms_norm"]
    assert all(r["plain"] and r["backend"] == "cpu" and r["device"] == "cpu" for r in rows)
    assert set(ops.launches().values()) == {0}
    table = tkp.format_table(rows)
    assert table.count("plain") == len(rows)
    bad = dict(rows[0], plain=False)
    with pytest.raises(AssertionError):
        tkp.validate_profile([bad])


def test_paper_shapes_and_bounds():
    """bert-base at M=32, bs 1, S 128: the matmul and norm shapes the issue
    of the paper's evaluation names, and their byte bounds."""
    cfg = treg.get_config("bert-base").with_(num_instances=32)
    shapes = tkp.paper_shapes(cfg)
    assert shapes == {"fused_matmul": dict(m=32, t=128, d=768, f=3072),
                      "group_rms_norm": dict(m=32, t=128, d=768)}
    nbytes = 2 * (32 * 128 * 768 + 32 * 768 * 3072 + 32 * 128 * 3072)
    assert abs(nbytes / tkp.HBM_BYTES_PER_S - 0.0545e-3) < 1e-7
    assert tkp.PEAK_FLOPS == {"bfloat16": 989e12, "float32": 67e12}


@pytest.mark.parametrize("s,chunk", [(32, 32), (256, 64)])
def test_mlstm_flops_count_the_carried_state_only_after_the_first_chunk(s, chunk):
    """From the zero state the first chunk needs k^T v, q k^T and w v only;
    each later chunk adds q C and the decay of C."""
    lanes, hd = 64, 1024
    first = 2 * chunk * hd * hd + 4 * chunk * chunk * hd
    later = first + 2 * chunk * hd * hd + hd * hd
    want = lanes * (first + (s // chunk - 1) * later)
    assert tkp.mlstm_chunkwise_flops(lanes, s, hd, chunk) == want
    if s == chunk:
        # the xlstm-1.3b profiler shape: 4.56 GFLOP, 0.068 ms at the f32 peak,
        # under the 0.085 ms its bytes take: bound by bytes
        assert abs(want - 4.563e9) < 1e6


def test_roofline_cli_on_cpu(tmp_path):
    out = tmp_path / "rows.json"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    r = subprocess.run([sys.executable, str(REPO / "benchmarks" / "torch_roofline_table.py"),
                        "--achieved", "--device", "cpu", "--arch", "xlstm-1.3b", "--repeats",
                        "1", "--achieved-context", "32", "--achieved-chunk", "8",
                        "--achieved-json", str(out)],
                       capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    rows = json.loads(out.read_text())
    assert [row["kernel"] for row in rows] == list(tkp.KERNELS)
    assert all(row["plain"] for row in rows) and "plain PyTorch versions" in r.stdout
