"""The CLI's flags that need parts not ported yet: each raises
NotImplementedError naming its ROADMAP Queue 1 item before anything is
built or trained (a case of tests/test_torch_driver.py's CLI checks)."""

import pytest

from sdeflow_tpu_torch import run


UNPORTED = [
    (["--dp", "2"], "item 14"),
    (["--tp", "2"], "item 14"),
    (["--attention-impl", "ring"], "item 14"),
    (["--print-ram"], "item 15"),
    ([], "item 13b"),  # plots: no --no-plots
]


@pytest.mark.parametrize("flags,item", UNPORTED)
def test_unported_flags_raise_before_training(tmp_path, flags, item):
    out = tmp_path / "res"
    plots = [] if not flags else ["--no-plots"]
    with pytest.raises(NotImplementedError, match=item):
        run.main(["--preset", "grf16_dbg", "--cpu", "--results-dir",
                  str(out), *plots, *flags])
    assert not out.exists()
