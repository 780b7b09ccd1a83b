"""Every preset of the JAX package resolves in the port, by itself and
with the ``_dbg`` shrink, and equals the JAX one field by field
(``dataclasses.fields`` of the port's config tree, its types too); the
two registries hold the same names; an unknown name raises KeyError in
both. The first twelve names here, the rest in
tests/test_torch_presets_signal_2.py."""

import dataclasses

import pytest

from sdeflow_tpu import configs as jax_configs
from sdeflow_tpu_torch import configs

NAMES = list(jax_configs.PRESETS)


def fields_equal(ours, ref, where):
    for f in dataclasses.fields(ours):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(a):
            fields_equal(a, b, f"{where}.{f.name}")
        else:
            assert a == b and type(a) is type(b), (where, f.name, a, b)


def check_preset(name):
    for n in (name, name + "_dbg"):
        ours, ref = configs.get_preset(n), jax_configs.get_preset(n)
        assert ours.name == ref.name == n
        fields_equal(ours, ref, n)


@pytest.mark.parametrize("name", NAMES[:12])
def test_preset_matches_jax_field_by_field(name):
    check_preset(name)


def test_registries_hold_the_same_presets():
    assert list(configs.PRESETS) == NAMES and len(NAMES) == 23


def test_unknown_preset_raises_key_error():
    for mod in (configs, jax_configs):
        with pytest.raises(KeyError, match="unknown preset"):
            mod.get_preset("lorenz64_dbg")
