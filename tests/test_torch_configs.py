"""The port's configs equal the reference's field for field (the port
drops only ``use_pallas_kernels``: there the device picks the path)."""
import dataclasses

import pytest

from repro.configs import registry as jreg
from repro_torch.configs import registry as treg

DENSE = ["tinyllama-1.1b", "qwen1.5-0.5b", "granite-3-2b", "deepseek-67b"]
MOE = ["olmoe-1b-7b", "qwen3-moe-30b-a3b"]
SERVED = DENSE + ["xlstm-1.3b", "hymba-1.5b"] + MOE + ["internvl2-26b"]
PAPER = ["resnet50", "resnext50", "bert-base", "xlnet-base"]
AUDIO = "whisper-small"
PORTED = SERVED + [AUDIO] + PAPER


def _fields(cfg):
    d = dataclasses.asdict(cfg)
    d.pop("use_pallas_kernels", None)
    return d


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("smoke", [False, True])
def test_dense_config_matches_reference(arch, smoke):
    get = "get_smoke_config" if smoke else "get_config"
    want = _fields(getattr(jreg, get)(arch))
    got = dataclasses.asdict(getattr(treg, get)(arch))
    assert got == want


@pytest.mark.parametrize("smoke", [False, True])
def test_ssm_config_matches_reference(smoke):
    get = "get_smoke_config" if smoke else "get_config"
    assert dataclasses.asdict(getattr(treg, get)("xlstm-1.3b")) == _fields(
        getattr(jreg, get)("xlstm-1.3b"))


@pytest.mark.parametrize("smoke", [False, True])
def test_hybrid_config_matches_reference(smoke):
    get = "get_smoke_config" if smoke else "get_config"
    assert dataclasses.asdict(getattr(treg, get)("hymba-1.5b")) == _fields(
        getattr(jreg, get)("hymba-1.5b"))


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("smoke", [False, True])
def test_moe_config_matches_reference(arch, smoke):
    get = "get_smoke_config" if smoke else "get_config"
    assert dataclasses.asdict(getattr(treg, get)(arch)) == _fields(getattr(jreg, get)(arch))


@pytest.mark.parametrize("smoke", [False, True])
def test_vlm_config_matches_reference(smoke):
    get = "get_smoke_config" if smoke else "get_config"
    assert dataclasses.asdict(getattr(treg, get)("internvl2-26b")) == _fields(
        getattr(jreg, get)("internvl2-26b"))


@pytest.mark.parametrize("smoke", [False, True])
def test_audio_config_matches_reference(smoke):
    get = "get_smoke_config" if smoke else "get_config"
    assert dataclasses.asdict(getattr(treg, get)(AUDIO)) == _fields(getattr(jreg, get)(AUDIO))


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k", "long_500k"])
def test_audio_config_for_shape_matches_reference(shape):
    """As in the reference, whisper runs every shape but long_500k (a fixed
    encoder horizon), for which both raise."""
    assert treg.supported(AUDIO, shape) is jreg.supported(AUDIO, shape) is (shape != "long_500k")
    if shape == "long_500k":
        for reg in (treg, jreg):
            with pytest.raises(ValueError):
                reg.config_for_shape(AUDIO, shape)
        return
    want = _fields(jreg.config_for_shape(AUDIO, shape, num_instances=4))
    assert dataclasses.asdict(treg.config_for_shape(AUDIO, shape, num_instances=4)) == want


@pytest.mark.parametrize("arch", PAPER)
@pytest.mark.parametrize("smoke", [False, True])
def test_paper_config_matches_reference(arch, smoke):
    get = "get_smoke_config" if smoke else "get_config"
    assert dataclasses.asdict(getattr(treg, get)(arch)) == _fields(getattr(jreg, get)(arch))


@pytest.mark.parametrize("arch", PAPER)
def test_paper_models_run_no_serving_shape(arch):
    """As in the reference, the cnn and encoder families run no shape of
    SHAPES: they are called through their modules."""
    for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        assert treg.supported(arch, shape) is jreg.supported(arch, shape) is False
        with pytest.raises(ValueError):
            treg.config_for_shape(arch, shape)


@pytest.mark.parametrize("arch", SERVED)
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k", "long_500k"])
def test_config_for_shape_matches_reference(arch, shape):
    want = _fields(jreg.config_for_shape(arch, shape, num_instances=4))
    got = dataclasses.asdict(treg.config_for_shape(arch, shape, num_instances=4))
    assert got == want


def test_registry_ids_match_and_unported_raise(monkeypatch):
    """Every assigned arch and paper model is ported; a known id left out
    of ``PORTED`` raises "not ported yet", an unknown one KeyError."""
    assert treg.ASSIGNED == jreg.ASSIGNED and treg.PAPER_MODELS == jreg.PAPER_MODELS
    assert sorted(treg.PORTED) == sorted(PORTED)
    assert set(treg.ASSIGNED) | set(treg.PAPER_MODELS) == set(treg.PORTED)
    assert treg.get_config(AUDIO).family == "audio"
    monkeypatch.setattr(treg, "PORTED", tuple(a for a in treg.PORTED if a != AUDIO))
    with pytest.raises(NotImplementedError, match="not ported yet"):
        treg.get_config(AUDIO)
    with pytest.raises(KeyError):
        treg.get_config("no-such-arch")
