"""Checkpoint/resume: block-k restart must be bit-identical to
uninterrupted streaming (SURVEY.md §5 contract)."""

import numpy as np
import pytest

from sdr_fm import checkpoint
from sdr_fm import config as cfg
from sdr_fm.models import receiver as trx
from sdr_fm.utils import synth


class TestNpzRoundtrip:
    def test_block_k_restart_bit_identical(self, tmp_path):
        mc = cfg.get_mode_config(0)
        bs = mc.default_block_size(with_rds=True)
        res = synth.synthesize_fm(duration_s=0.25, mode=0, with_rds=True,
                                  seed=8)
        iq = synth.u8_to_float(res.iq_u8)
        n_blocks = len(iq) // bs

        # uninterrupted run
        rx1 = trx.Receiver(0, stereo=True, with_rds=True)
        outs1 = [rx1.process(iq[b * bs:(b + 1) * bs])
                 for b in range(n_blocks)]

        # run 2 blocks, checkpoint, restart in a fresh receiver
        rx2 = trx.Receiver(0, stereo=True, with_rds=True)
        for b in range(2):
            rx2.process(iq[b * bs:(b + 1) * bs])
        p = str(tmp_path / "state.npz")
        checkpoint.save(p, rx2.state, mode=0, block_count=2)

        rx3 = trx.Receiver(0, stereo=True, with_rds=True)
        state, meta = checkpoint.load(p)
        assert meta["block_count"] == 2
        rx3.state = state
        for b in range(2, n_blocks):
            out = rx3.process(iq[b * bs:(b + 1) * bs])
            np.testing.assert_array_equal(np.asarray(out.left),
                                          np.asarray(outs1[b].left))
            np.testing.assert_array_equal(np.asarray(out.rds_symbols),
                                          np.asarray(outs1[b].rds_symbols))

    def test_orbax_roundtrip(self, tmp_path):
        import jax
        rx1 = trx.Receiver(0, stereo=True, with_rds=True)
        # make the state non-trivial
        res = synth.synthesize_fm(duration_s=0.05, mode=0, seed=2)
        iq = synth.u8_to_float(res.iq_u8)
        bs = cfg.get_mode_config(0).default_block_size(True)
        rx1.process(iq[:bs])
        d = str(tmp_path / "orbax_ck")
        checkpoint.save_orbax(d, rx1.state)
        template = trx.init_state(cfg.get_mode_config(0))
        restored = checkpoint.load_orbax(d, template)
        for a, b in zip(jax.tree.leaves(restored),
                        jax.tree.leaves(rx1.state)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_meta_and_shapes_preserved(self, tmp_path):
        mc = cfg.get_mode_config(2)
        rx1 = trx.Receiver(2, stereo=True, with_rds=True)
        p = str(tmp_path / "s.npz")
        checkpoint.save(p, rx1.state, mode=2, block_count=7,
                        extra={"station": "test"})
        state, meta = checkpoint.load(p)
        assert meta["mode"] == 2 and meta["extra"]["station"] == "test"
        import jax
        for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(rx1.state)):
            assert a.shape == b.shape and a.dtype == b.dtype


class TestInputDtypeContract:
    """The u8/float state-dtype contract must fail LOUDLY:
    resuming a float-produced checkpoint with raw-u8 input would silently
    quantize the carried RF tail to the nearest 1/128."""

    def _float_state(self):
        mc = cfg.get_mode_config(0)
        bs = mc.default_block_size(with_rds=False)
        res = synth.synthesize_fm(duration_s=0.06, mode=0, seed=5)
        rx1 = trx.Receiver(0, stereo=True, with_rds=False)
        # scale off the 1/128 grid: a genuinely float-valued input (the
        # bare u8_to_float output is still exactly k/128 and would pass)
        rx1.process(synth.u8_to_float(res.iq_u8)[:bs] * np.float32(0.7))
        return rx1.state

    def test_recorded_mismatch_refused(self, tmp_path):
        p = str(tmp_path / "f32.npz")
        checkpoint.save(p, self._float_state(), mode=0,
                        input_dtype="float32")
        with pytest.raises(ValueError, match="produced from float32"):
            checkpoint.load(p, expect_input_dtype="uint8")
        # same-dtype resume is fine
        checkpoint.load(p, expect_input_dtype="float32")

    def test_legacy_checkpoint_tail_validated(self, tmp_path, capsys):
        """A checkpoint with NO dtype record (pre-r5) gets the direct
        host-side tail check: float-contaminated tails raise, u8-clean
        tails pass with a warning only."""
        st = self._float_state()
        p = str(tmp_path / "legacy.npz")
        checkpoint.save(p, st, mode=0)                  # no input_dtype
        with pytest.raises(ValueError, match="not 1/128-quantized"):
            checkpoint.load(p, expect_input_dtype="uint8")
        # a u8-produced state passes the same check
        res = synth.synthesize_fm(duration_s=0.06, mode=0, seed=5)
        rx2 = trx.Receiver(0, stereo=True, with_rds=False)
        bs = cfg.get_mode_config(0).default_block_size(with_rds=False)
        rx2.process(res.iq_u8[:bs])                     # raw u8 input
        p2 = str(tmp_path / "legacy_u8.npz")
        checkpoint.save(p2, rx2.state, mode=0)
        checkpoint.load(p2, expect_input_dtype="uint8")

    def test_validator_direct(self):
        trx.validate_u8_rf_state(np.arange(-128, 128) / 128.0,
                                 np.zeros(150))
        with pytest.raises(ValueError, match="rf_q"):
            trx.validate_u8_rf_state(np.zeros(3), np.asarray([0.001]))
