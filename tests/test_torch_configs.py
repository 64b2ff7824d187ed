"""The port's ``--arch`` config modules (``repro_torch.configs``) against
the JAX reference's ``repro.configs``: the same ids, and each module's
``CONFIG``, ``SMOKE`` and ``SHAPES`` equal field by field (the port's
modules read ``repro_torch.models.registry``, a copy of the reference's
registry)."""
import dataclasses
import importlib

import pytest

torch = pytest.importorskip("torch")

import repro.configs as jconfigs  # noqa: E402

import repro_torch.configs as configs  # noqa: E402
from repro_torch.models import registry  # noqa: E402

MODULES = ("starcoder2_3b", "starcoder2_15b", "deepseek_7b",
           "h2o_danube_3_4b", "pixtral_12b", "deepseek_v3_671b",
           "granite_moe_1b_a400m", "xlstm_1_3b", "whisper_tiny",
           "zamba2_1_2b")


def test_arch_ids_equal_and_cover_the_registry():
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    assert sorted(configs.ARCH_IDS) == sorted(registry.ARCHS)


@pytest.mark.parametrize("name", MODULES)
def test_module_equals_the_reference(name):
    port = importlib.import_module(f"repro_torch.configs.{name}")
    ref = importlib.import_module(f"repro.configs.{name}")
    assert configs.get(port.ARCH) is port
    assert port.ARCH == ref.ARCH
    assert dataclasses.asdict(port.CONFIG) == dataclasses.asdict(ref.CONFIG)
    assert dataclasses.asdict(port.SMOKE) == dataclasses.asdict(ref.SMOKE)
    assert port.SHAPES == ref.SHAPES
    assert port.CONFIG is registry.ARCHS[port.ARCH]
    with open(port.__file__) as f:
        assert f.readline().startswith("# seed: unused")
