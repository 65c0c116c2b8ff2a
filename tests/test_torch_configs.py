"""The port's configs equal the reference's field for field (the port
drops only ``use_pallas_kernels``: there the device picks the path)."""
import dataclasses

import pytest

from repro.configs import registry as jreg
from repro_torch.configs import registry as treg

DENSE = ["tinyllama-1.1b", "qwen1.5-0.5b", "granite-3-2b", "deepseek-67b"]


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


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k", "long_500k"])
def test_config_for_shape_matches_reference(arch, shape):
    want = _fields(jreg.config_for_shape(arch, shape, num_instances=4))
    got = dataclasses.asdict(treg.config_for_shape(arch, shape, num_instances=4))
    assert got == want


def test_registry_ids_match_and_unported_raise():
    assert treg.ASSIGNED == jreg.ASSIGNED and treg.PAPER_MODELS == jreg.PAPER_MODELS
    with pytest.raises(NotImplementedError, match="not ported yet"):
        treg.get_config("olmoe-1b-7b")
    with pytest.raises(KeyError):
        treg.get_config("no-such-arch")
