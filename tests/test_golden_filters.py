"""Golden filter-layer properties.

Mirrors the reference's own verification strategy (SURVEY.md section 4):
block-streaming outputs must equal single-pass contiguous processing, and the
polyphase resampler must equal brute-force upsample->filter->downsample.
"""

import numpy as np
import pytest

from sdr_fm.golden import filters


def _stream(x, fn, state, block):
    outs = []
    for b in range(len(x) // block):
        y, state = fn(x[b * block:(b + 1) * block], state)
        outs.append(y)
    return np.concatenate(outs)


class TestCoeffs:
    def test_lowpass_matches_scalar_formula(self):
        n, fs, fc = 101, 240e3, 16e3
        h = filters.lowpass_taps(n, fs, fc)
        norm = fc / (fs / 2)
        for i in [0, 17, 50, 100]:
            if i == (n - 1) / 2:
                ref = norm
            else:
                xx = np.pi * norm * (i - (n - 1) / 2)
                ref = norm * np.sin(xx) / xx
            ref *= np.sin(i * np.pi / n) ** 2
            assert h[i] == pytest.approx(ref, rel=1e-12)

    def test_lowpass_dc_gain(self):
        h = filters.lowpass_taps(151, 2.4e6, 100e3)
        assert np.sum(h) == pytest.approx(1.0, abs=0.01)

    def test_bandpass_rejects_out_of_band(self):
        fs = 240e3
        h = filters.bandpass_taps(151, fs, 18.5e3, 19.5e3)
        t = np.arange(4096) / fs
        inband = np.sin(2 * np.pi * 19e3 * t)
        outband = np.sin(2 * np.pi * 5e3 * t)
        gi = np.std(np.convolve(inband, h, "valid"))
        go = np.std(np.convolve(outband, h, "valid"))
        assert gi > 50 * go

    def test_rrc_symmetry_and_peak(self):
        h = filters.rrc_taps(2375 * 26, 101)
        # center is at N/2 = 50.5, so taps 50 and 51 straddle the peak
        assert np.argmax(h) in (50, 51)
        np.testing.assert_allclose(h[50], h[51], rtol=1e-12)
        # peak is close to (but, with the half-sample offset, not exactly)
        # the analytic t=0 value
        assert h[50] == pytest.approx(1.0 + 0.9 * (4 / np.pi - 1), rel=2e-3)


class TestBlockFir:
    def test_stream_equals_contiguous(self, rng):
        h = filters.lowpass_taps(31, 10.0, 1.0)
        x = rng.normal(size=4096)
        want = np.convolve(np.concatenate([np.zeros(30), x]), h, "valid")
        got = _stream(x, lambda b, s: filters.block_fir(b, h, s),
                      np.zeros(30), 256)
        np.testing.assert_allclose(got, want, atol=1e-12)

    def test_decim_stream_equals_contiguous(self, rng):
        h = filters.lowpass_taps(151, 2.4e6, 100e3)
        x = rng.normal(size=20000)
        full = np.convolve(np.concatenate([np.zeros(150), x]), h, "valid")
        want = full[::10]
        got = _stream(x, lambda b, s: filters.block_fir_decim(b, h, s, 10),
                      np.zeros(150), 4000)
        np.testing.assert_allclose(got, want, atol=1e-12)

    def test_resample_matches_bruteforce(self, rng):
        u, d, taps = 3, 4, 33  # taps = 11*u
        h = filters.lowpass_taps(taps, 10.0, 1.0)
        x = rng.normal(size=240)
        # brute force: zero-stuff, full causal FIR, stride D, gain U
        xu = np.zeros(len(x) * u)
        xu[::u] = x
        full = np.convolve(np.concatenate([np.zeros(taps - 1), xu]), h,
                           "valid")
        want = u * full[::d]
        state = np.zeros(filters.resample_state_len(taps, u))
        got = _stream(x, lambda b, s: filters.block_fir_resample(b, h, s,
                                                                 d, u), state,
                      60)
        np.testing.assert_allclose(got, want, atol=1e-12)

    def test_resample_mode2_shape(self, rng):
        """Mode-2 audio resampler: 147 up / 800 down, 101*147 taps."""
        u, d = 147, 800
        taps = 101 * u
        h = filters.lowpass_taps(taps, 240e3 * u, 16e3)
        x = rng.normal(size=5600)
        state = np.zeros(filters.resample_state_len(taps, u))
        y, state2 = filters.block_fir_resample(x, h, state, d, u)
        assert len(y) == 5600 * u // d == 1029
        assert len(state2) == 100

    def test_allpass_is_pure_delay(self, rng):
        x = rng.normal(size=1000)
        state = np.zeros(75)
        got = _stream(x, filters.allpass_delay, state, 100)
        np.testing.assert_array_equal(got[75:], x[: len(got) - 75])
        np.testing.assert_array_equal(got[:75], np.zeros(75))
