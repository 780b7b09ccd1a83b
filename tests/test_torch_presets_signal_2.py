"""The JAX package's presets from the thirteenth on, by themselves and
with the ``_dbg`` shrink, field by field in the port (the checks of
tests/test_torch_presets_signal.py)."""

import pytest

from test_torch_presets_signal import NAMES, check_preset


@pytest.mark.parametrize("name", NAMES[12:])
def test_preset_matches_jax_field_by_field(name):
    check_preset(name)
