"""Golden demod/PLL/RDS-bit-level behavior on controlled inputs."""

import numpy as np
import pytest

from sdr_fm.golden import demod, pll, rds
from sdr_fm.utils import synth


class TestDemod:
    def test_quad_demod_recovers_tone(self, rng):
        # small deviation: the quad discriminator emits sin(dphi) ~= dphi,
        # so keep dphi small for the linearity check
        fs, f_dev, f_tone = 240e3, 5e3, 1e3
        t = np.arange(48000) / fs
        m = np.sin(2 * np.pi * f_tone * t)
        phase = 2 * np.pi * f_dev * np.cumsum(m) / fs
        i, q = np.cos(phase), np.sin(phase)
        y, _ = demod.fm_demod_quad(i, q, np.zeros(2))
        # demod output ~ d(phase) = 2*pi*f_dev/fs * m
        scale = 2 * np.pi * f_dev / fs
        np.testing.assert_allclose(y[10:], scale * m[10:], atol=scale * 0.02)

    def test_quad_zero_power_emits_zero(self):
        y, _ = demod.fm_demod_quad(np.zeros(8), np.zeros(8), np.zeros(2))
        np.testing.assert_array_equal(y, np.zeros(8))

    def test_arctan_matches_quad_approx(self, rng):
        fs = 240e3
        t = np.arange(8000) / fs
        phase = 2 * np.pi * 4e3 * np.cumsum(
            np.sin(2 * np.pi * 700 * t)) / fs
        i, q = np.cos(phase), np.sin(phase)
        ya, _ = demod.fm_demod_arctan(i, q, 0.0)
        yq, _ = demod.fm_demod_quad(i, q, np.zeros(2))
        # the quad discriminator is a first-order approx of the phase diff
        np.testing.assert_allclose(ya[10:], yq[10:], atol=2e-3)

    def test_demod_stream_equals_contiguous(self, rng):
        i = rng.normal(size=1000) + 2.0
        q = rng.normal(size=1000)
        want, _ = demod.fm_demod_quad(i, q, np.zeros(2))
        st = np.zeros(2)
        parts = []
        for b in range(10):
            y, st = demod.fm_demod_quad(i[b * 100:(b + 1) * 100],
                                        q[b * 100:(b + 1) * 100], st)
            parts.append(y)
        np.testing.assert_allclose(np.concatenate(parts), want, atol=1e-12)


class TestPll:
    def test_locks_to_pilot_and_doubles(self):
        """PLL on a 19 kHz pilot: x2 NCO output must converge to a 38 kHz
        carrier coherent with the input (stereo use, model/stereo.py:219)."""
        fs, f = 240e3, 19e3
        n = 24000
        t = np.arange(n) / fs
        x = 0.5 * np.sin(2 * np.pi * f * t + 0.7)
        nco, _, _ = pll.fm_pll(x, f, fs, pll.PllState(nco_q_last=0.0),
                               nco_scale=2.0)
        # after settling, nco should be cos at exactly 2f with stable phase:
        # check cycle-rate via zero crossings over the last quarter
        seg = nco[1:][-6000:]
        crossings = np.sum(np.abs(np.diff(np.signbit(seg))))
        f_est = crossings / 2 * fs / len(seg)
        assert f_est == pytest.approx(2 * f, rel=0.01)

    def test_state_carry_stream_equals_contiguous(self):
        fs, f = 240e3, 19e3
        t = np.arange(4000) / fs
        x = np.sin(2 * np.pi * (f + 40) * t + 0.3)
        want, wantq, _ = pll.fm_pll(x, f, fs, pll.PllState(nco_q_last=0.0))
        st = pll.PllState(nco_q_last=0.0)
        got, gotq = [want[0]], [wantq[0]]
        for b in range(4):
            nco, ncoq, st = pll.fm_pll(x[b * 1000:(b + 1) * 1000], f, fs, st)
            got.extend(nco[1:])
            gotq.extend(ncoq[1:])
        np.testing.assert_allclose(got, want, atol=1e-9)
        np.testing.assert_allclose(gotq, wantq, atol=1e-9)


class TestRdsBits:
    def test_encode_decode_roundtrip(self, rng):
        info, framed = synth.rds_encode_groups(rng, 5)
        res = rds.frame_sync(framed)
        assert [o for _, o in res.matches[:4]] == ["A", "B", "C", "D"]
        assert len(res.matches) == 20
        # recover info bits from matches
        for g in range(5):
            for b in range(4):
                pos = res.matches[g * 4 + b][0]
                np.testing.assert_array_equal(
                    framed[pos:pos + 16], info[g, b])

    def test_frame_sync_with_bit_offset(self, rng):
        _, framed = synth.rds_encode_groups(rng, 3)
        shifted = np.concatenate([rng.integers(0, 2, 13), framed])
        res = rds.frame_sync(shifted)
        assert res.matches[0][0] >= 13
        assert [o for _, o in res.matches[:4]] == ["A", "B", "C", "D"]

    def test_diff_manchester_roundtrip(self, rng):
        bits = rng.integers(0, 2, 200)
        tx = synth.manchester_encode(synth.diff_encode(bits))
        # add noise below decision threshold
        soft = tx * (0.5 + 0.4 * rng.random(len(tx)))
        manch = rds.manchester_decode(soft)
        got = rds.diff_decode(manch)
        np.testing.assert_array_equal(got, bits)

    def test_cdr_robust_recovers_symbols(self, rng):
        bits = rng.integers(0, 2, 100)
        symbols = synth.manchester_encode(synth.diff_encode(bits))
        sps = 26
        # build an oversampled soft waveform with peaks at phase 7
        x = np.zeros(len(symbols) * sps)
        x[7::sps] = symbols
        x += rng.normal(0, 0.05, len(x))
        manch, phase, parity = rds.cdr_robust(x, sps)
        assert phase == 7 and parity == 0
        got = rds.diff_decode(manch)
        np.testing.assert_array_equal(got, bits)

    def test_cdr_reference_algorithm_basic(self):
        """Faithful CDR on a clean alternating symbol stream."""
        sps = 10
        symbols = np.array([+1, -1, -1, +1, +1, -1, -1, +1] * 10, float)
        x = np.zeros(len(symbols) * sps)
        x[0::sps] = symbols
        # smear so every sample has the symbol's sign (RRC-ish plateau)
        x = np.convolve(x, np.ones(3) / 3, "same")
        bits, st = rds.cdr(x, sps, rds.CdrState(), block_count=0)
        # symbols alternate (+,-),(-,+)... -> manchester 1,0,1,0,...
        np.testing.assert_array_equal(bits[:6], [1, 0, 1, 0, 1, 0])
        assert st.prev_size == len(symbols)


class TestCdrFuzz:
    """The symbol decoders must never crash or loop forever on arbitrary
    soft-symbol streams (the reference CDR's restart loop is the risk)."""

    def test_reference_cdr_on_noise(self, rng):
        from sdr_fm.golden import rds as grds
        st = grds.CdrState()
        for b in range(4):
            x = rng.normal(size=26 * 40) * 0.6
            bits, st = grds.cdr(x, 26, st, b)
            assert np.isfinite(bits).all() and len(bits) <= 26 * 40

    def test_robust_and_tracking_on_noise_and_extremes(self, rng):
        from sdr_fm.golden import rds as grds
        for x in [rng.normal(size=26 * 100),
                  np.zeros(26 * 100),
                  np.full(26 * 100, 5.0),
                  rng.normal(size=26 * 3)]:
            b1, _, _ = grds.cdr_robust(x, 26)
            b2 = grds.cdr_tracking(x, 26, window_symbols=32)
            assert set(np.unique(b1)).issubset({0, 1})
            assert set(np.unique(b2)).issubset({0, 1})
