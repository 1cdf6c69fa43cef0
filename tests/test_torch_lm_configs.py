"""The port's LM config registry (``repro_torch.configs``) against the JAX
package's: every ``ARCH_IDS`` config and its ``reduced()`` field for field,
``SHAPES``, ``applicable_shapes``, the ``"wisk"`` entry and the unknown-name
error. Pure data: exact equality."""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro_torch import configs  # noqa: E402


def test_arch_ids_equal():
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    assert len(configs.ARCH_IDS) == 10


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
@pytest.mark.parametrize("reduced", [False, True], ids=["published", "reduced"])
def test_config_equal(arch, reduced):
    got, want = configs.get_config(arch), jconfigs.get_config(arch)
    if reduced:
        got, want = got.reduced(), want.reduced()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]
    assert got.d_inner == want.d_inner
    assert configs.applicable_shapes(got) == jconfigs.applicable_shapes(want)


def test_field_defaults_and_post_init_equal():
    mk = dict(name="x", family="dense", n_layers=2, d_model=96, n_heads=3, n_kv_heads=1,
              d_ff=64, vocab=100)
    for extra in ({}, dict(head_dim=16), dict(dt_rank=5), dict(subquadratic=True),
                  dict(has_decode=False)):
        got, want = configs.ArchConfig(**mk, **extra), jconfigs.ArchConfig(**mk, **extra)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert configs.applicable_shapes(got) == jconfigs.applicable_shapes(want)


def test_shapes_and_wisk_equal():
    assert configs.SHAPES == jconfigs.SHAPES
    assert dataclasses.asdict(configs.get_config("wisk")) == dataclasses.asdict(
        jconfigs.get_config("wisk"))
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("gpt-9")
