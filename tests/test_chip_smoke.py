"""chip_smoke.py's phases at tiny sizes on the CPU (the kernel in the
Pallas interpreter, four of the eight virtual devices), and its refusal
to run without a GPU."""

import os
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def test_main_refuses_cpu(capsys):
    """No GPU: exit code 1 and no result line."""
    assert cs.main([]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "no GPU" in out.err


def test_check_raises():
    cs.check(True, "fine")
    with pytest.raises(cs.CheckFailed, match="broken"):
        cs.check(False, "broken")


def test_phase_cli():
    rec = cs.phase_cli(duration_s=1.0, golden_s=0.5)
    assert rec["ok"] and rec["max_err"] <= rec["tol"]
    assert min(rec["separation_db"]) > 30.0


def test_phase_serving():
    rec = cs.phase_serving(channels=8, distinct=4, n_blocks=16)
    assert rec["ok"] and rec["min_rds_words"] > 0


def test_phase_modes():
    rec = cs.phase_modes(duration_s=0.3)
    assert set(rec["errors"]) == {"1", "2", "3"}


def test_phase_wideband():
    rec = cs.phase_wideband(duration_s=1.0)
    assert len(rec["stations"]) == 3


def test_phase_kernels():
    rec = cs.phase_kernels(lanes=8, steps=200, n_blocks=2, channels=(1, 3),
                           interpret=True)
    assert rec["max_err"] == 0.0       # interpreted: bit-identical
    assert all(v <= rec["fir_tol"]["bf16x"]
               for v in rec["fir_rel_rms"].values())


def test_phase_four_cards():
    rec = cs.phase_four_cards(jax.devices()[:4], channels=16, distinct=4,
                              n_blocks=4, archive_s=1.0, tile_s=0.5,
                              mesh2d_s=0.5)
    assert rec["devices"] == 4
    # FIR arms of the time-sharded runs are bit-identical here
    assert rec["errors"]["time_single/fm_demod"] == 0.0
