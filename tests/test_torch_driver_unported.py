"""The CLI's flags that need the parallel module, not ported yet: each
raises NotImplementedError naming ROADMAP Queue 1 item 14 before anything
is built or trained (a case of tests/test_torch_driver.py's CLI checks;
the plots and --print-ram run: tests/test_torch_driver_plots.py)."""

import pytest

from sdeflow_tpu_torch import run


UNPORTED = [
    (["--dp", "2"], "item 14"),
    (["--tp", "2"], "item 14"),
    (["--attention-impl", "ring"], "item 14"),
]


@pytest.mark.parametrize("flags,item", UNPORTED)
def test_unported_flags_raise_before_training(tmp_path, flags, item):
    out = tmp_path / "res"
    with pytest.raises(NotImplementedError, match=item):
        run.main(["--preset", "grf16_dbg", "--cpu", "--results-dir",
                  str(out), "--no-plots", *flags])
    assert not out.exists()
