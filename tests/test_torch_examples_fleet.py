"""The port's two fleet examples against the reference's: both scripts
run whole, on the same fixed seeds, and their standard output is equal
byte for byte (the fleet path is NumPy on the host in both packages and
prints no wall-clock time)."""
import contextlib
import io

import pytest

from tests._torch_parity import load_example


def _stdout(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return buf.getvalue(), out


@pytest.mark.parametrize("name", ["fleet_simulation", "fault_tolerant_fleet"])
def test_fleet_example_prints_the_references_bytes(name):
    want, _ = _stdout(load_example(name).main)
    got, out = _stdout(load_example(f"torch_{name}").main, ["--device", "cpu"])
    assert want.count("\n") > 10
    assert got == want
    assert out                      # the port's main returns its summaries
