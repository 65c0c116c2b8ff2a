"""The port's data pipeline and LR schedules against the JAX package's.

Batches are drawn by the same numpy ``default_rng`` calls in the same
order, so they are the reference's bit for bit (tokens, labels, and the
vlm / audio stub embeddings, bf16 compared by their bits).  The
schedules are float32 functions of the step: equal to the reference's
at steps 0-50 within 1e-7 of the largest value.  (AdamW against the reference's own
gradients is in ``test_torch_train.py``, beside the model that makes
them.)
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.data import pipeline as jpipe
from repro.optim import schedules as jsched
from repro_torch.configs import registry as treg
from repro_torch.data import pipeline as tpipe
from repro_torch.optim import schedules as tsched


def _bits(x):
    """An array's exact bits as numpy (bf16 viewed as int16)."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == jnp.bfloat16 else x


def _assert_batch_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = _bits(got[k]), _bits(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("m,seed", [(1, 0), (3, 7)])
def test_synthetic_lm_batches_are_the_references(m, seed):
    j, t = jpipe.SyntheticLM(257, m, seed), tpipe.SyntheticLM(257, m, seed)
    for step in (0, 1, 5):
        got = t.batch(step, 3, 17)
        assert got["tokens"].dtype == torch.int32
        _assert_batch_equal(got, j.batch(step, 3, 17))


def test_memmap_lm_batches_are_the_references(tmp_path):
    toks = np.random.default_rng(3).integers(0, 1000, 5000)
    paths = []
    for i, write in enumerate((jpipe.write_token_file, tpipe.write_token_file)):
        paths.append(tmp_path / f"shard{i}.bin")
        write(paths[-1], toks[i * 2000:i * 2000 + 3000])
    # each package's writer, read back by both packages' streams
    j = jpipe.MemmapLM([str(p) for p in paths], num_instances=2, seed=4)
    t = tpipe.MemmapLM([str(p) for p in paths], num_instances=2, seed=4)
    for step in (0, 1, 9):
        _assert_batch_equal(t.batch(step, 4, 31), j.batch(step, 4, 31))


@pytest.mark.parametrize("arch,dtype", [("internvl2-26b", None), ("whisper-small", None),
                                        ("internvl2-26b", "bfloat16")])
def test_vlm_and_audio_batches_are_the_references(arch, dtype):
    jcfg, tcfg = jreg.get_smoke_config(arch), treg.get_smoke_config(arch)
    if dtype:
        jcfg, tcfg = jcfg.with_(dtype=dtype), tcfg.with_(dtype=dtype)
    jcfg, tcfg = jcfg.with_(num_instances=2), tcfg.with_(num_instances=2)
    s = (jcfg.num_image_patches or 0) + 12
    for step in (0, 2):
        _assert_batch_equal(tpipe.make_batch(tcfg, step, 2, s, seed=5),
                            jpipe.make_batch(jcfg, step, 2, s, seed=5))


@pytest.mark.parametrize("name,args", [
    ("constant", (3e-3,)),
    ("linear_warmup", (1e-3, 10)),
    ("cosine_with_warmup", (3e-3, 5, 40)),
    ("cosine_with_warmup", (1e-2, 0, 1, 0.0)),
])
def test_schedules_are_the_references(name, args):
    j, t = getattr(jsched, name)(*args), getattr(tsched, name)(*args)
    got = np.array([t(s) for s in range(51)])
    want = np.array([float(j(jnp.int32(s))) for s in range(51)])
    assert all(isinstance(t(s), float) for s in (0, 50))
    # relative to the schedule's largest value: both sides round in f32,
    # and XLA's f32 cosine may differ from numpy's in its last bit
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7 * np.abs(want).max())
