"""End-to-end golden receiver on synthetic FM with known ground truth.

This is the validation the reference never had for RDS: a synthetic station
with known audio tones and known RDS group data, demodulated all the way to
audio samples and frame-synced RDS bits.
"""

import numpy as np
import pytest

from sdr_fm import config as cfg
from sdr_fm.golden import receiver
from sdr_fm.utils import synth


def _tone_power(x: np.ndarray, fs: float, f: float, bw: float = 60.0):
    """Power of x near frequency f (Goertzel-style via rfft)."""
    xf = np.fft.rfft(x * np.hanning(len(x)))
    freqs = np.fft.rfftfreq(len(x), 1 / fs)
    band = (freqs > f - bw) & (freqs < f + bw)
    total = np.sum(np.abs(xf) ** 2)
    return np.sum(np.abs(xf[band]) ** 2) / total


@pytest.fixture(scope="module")
def synth_mode0():
    return synth.synthesize_fm(duration_s=0.4, mode=0, with_stereo=True,
                               with_rds=True, seed=7)


class TestMonoStereo:
    def test_mono_recovers_both_tones(self, synth_mode0):
        mc = cfg.get_mode_config(0)
        iq = synth.u8_to_float(synth_mode0.iq_u8)
        outs = receiver.run_file(iq, mc, stereo=False)
        mono = np.concatenate([o.mono for o in outs])[2000:]
        # mono = (L+R)/2: both tones present
        assert _tone_power(mono, mc.audio_fs, 800.0) > 0.2
        assert _tone_power(mono, mc.audio_fs, 1500.0) > 0.2

    def test_stereo_separation(self, synth_mode0):
        mc = cfg.get_mode_config(0)
        iq = synth.u8_to_float(synth_mode0.iq_u8)
        outs = receiver.run_file(iq, mc, stereo=True)
        # skip PLL lock-in transient
        left = np.concatenate([o.left for o in outs])[6000:]
        right = np.concatenate([o.right for o in outs])[6000:]
        # L carries the 800 Hz tone, R the 1500 Hz tone
        l_800 = _tone_power(left, mc.audio_fs, 800.0)
        l_1500 = _tone_power(left, mc.audio_fs, 1500.0)
        r_800 = _tone_power(right, mc.audio_fs, 800.0)
        r_1500 = _tone_power(right, mc.audio_fs, 1500.0)
        assert l_800 > 5 * l_1500, (l_800, l_1500)
        assert r_1500 > 5 * r_800, (r_800, r_1500)


class TestRds:
    def test_rds_frames_decode(self, synth_mode0):
        mc = cfg.get_mode_config(0)
        iq = synth.u8_to_float(synth_mode0.iq_u8)
        outs = receiver.run_file(iq, mc, stereo=False, with_rds=True)
        all_matches = [m for o in outs if o.rds_frames
                       for m in o.rds_frames.matches]
        # after PLL/CDR settle we must sync to several RDS blocks
        assert len(all_matches) >= 4, all_matches

    def test_rds_info_words_recovered(self, synth_mode0):
        """Frame matches must carry the transmitted 16-bit info words —
        guards against chance syndrome matches (5/1024 per window)."""
        mc = cfg.get_mode_config(0)
        iq = synth.u8_to_float(synth_mode0.iq_u8)
        outs = receiver.run_file(iq, mc, stereo=False, with_rds=True)
        sent = {tuple(w) for g in synth_mode0.rds_info_bits for w in g}
        hits = 0
        # decode the full symbol stream in one pass with the robust CDR
        from sdr_fm.golden import rds as grds
        sym = np.concatenate([o.rds_symbols for o in outs
                              if o.rds_symbols is not None])
        manch, _, _ = grds.cdr_robust(sym, mc.rds.sps)
        bits = grds.diff_decode(manch)
        frames = grds.frame_sync(bits)
        offs = [off for _, off in frames.matches]
        assert len(frames.matches) >= 8, frames.matches
        for pos, _ in frames.matches:
            if tuple(bits[pos:pos + 16]) in sent:
                hits += 1
        assert hits >= len(frames.matches) - 1, (hits, len(frames.matches))
        # offsets must walk the canonical A,B,C,D cycle
        seq = "ABCD"
        idx = [seq.index(o) for o in offs if o in seq]
        assert all((b - a) % 4 == 1 for a, b in zip(idx, idx[1:])), offs


@pytest.mark.parametrize("mode", [1, 3])
def test_other_modes_mono(mode):
    mc = cfg.get_mode_config(mode)
    res = synth.synthesize_fm(duration_s=0.25, mode=mode, with_stereo=False,
                              with_rds=False, seed=3)
    iq = synth.u8_to_float(res.iq_u8)
    outs = receiver.run_file(iq, mc, stereo=False)
    mono = np.concatenate([o.mono for o in outs])[1000:]
    assert _tone_power(mono, mc.audio_fs, 800.0) > 0.2
    assert _tone_power(mono, mc.audio_fs, 1500.0) > 0.2
