"""Observability utilities: MAC model vs report Table 1, log emitters,
generators, plots."""

import os

import numpy as np
import pytest

from sdr_fm import config as cfg
from sdr_fm.utils import gen, logfiles, profiling


class TestMacModel:
    """The analytical MAC model must reproduce report Table 1
    (BASELINE.md rows 1-2) exactly for the integer modes and to rounding
    for the rational ones."""

    @pytest.mark.parametrize("mode,expected", [(0, 1111), (1, 1313),
                                               (2, 1200), (3, 1567)])
    def test_mono(self, mode, expected):
        mc = cfg.get_mode_config(mode)
        got = profiling.mac_per_audio_sample(mc, stereo=False, taps=101)
        assert abs(got - expected) < 3, (got, expected)

    @pytest.mark.parametrize("mode,expected", [(0, 2121), (1, 2525),
                                               (2, 2300), (3, 3033)])
    def test_stereo(self, mode, expected):
        mc = cfg.get_mode_config(mode)
        got = profiling.mac_per_audio_sample(mc, stereo=True, taps=101)
        assert abs(got - expected) < 6, (got, expected)


class TestStageTimer:
    def test_accumulates_and_reports(self):
        t = profiling.StageTimer()
        for _ in range(3):
            with t.span("front_end"):
                pass
        with t.span("audio"):
            pass
        assert t.counts["front_end"] == 3
        rep = t.report()
        assert "front_end" in rep and "audio" in rep


class TestStageProfile:
    def test_profile_stages_reports_arms(self):
        r = profiling.profile_stages(mode=0, n_blocks=2)
        for k in ("mono_ms", "stereo_ms", "stereo_arm_ms",
                  "stereo_rds_ms", "rds_arm_ms", "realtime_budget_ms"):
            assert k in r, k
        assert r["mono_ms"] > 0 and r["realtime_budget_ms"] == 24.0


class TestLogfiles:
    def test_dat_format(self, tmp_path):
        path = logfiles.log_vector("vec", [1.5, -2.25], out_dir=str(tmp_path))
        lines = open(path).read().strip().split("\n")
        assert len(lines) == 2
        i, v = lines[1].split("\t")
        assert float(i) == 1.0 and float(v) == -2.25


class TestGenerators:
    def test_generate_sin(self):
        x = gen.generate_sin(1000.0, 100.0, 1000)
        assert abs(x).max() <= 1.0
        xf = np.fft.rfft(x)
        assert np.argmax(np.abs(xf)) == 100

    def test_add_sin_superposition(self):
        x = gen.add_sin(1000.0, [50.0, 120.0], 1000)
        xf = np.abs(np.fft.rfft(x))
        peaks = set(np.argsort(xf)[-2:])
        assert peaks == {50, 120}

    def test_random_range(self):
        x = gen.random_samples(1000, 5.0, seed=1)
        assert abs(x).max() <= 5.0


class TestAnim:
    def test_gif_render(self, tmp_path):
        """Per-block PSD animation renders headless
        (ref model/fmMonoAnim.py)."""
        from sdr_fm.utils import anim, synth
        res = synth.synthesize_fm(duration_s=0.1, mode=0, with_rds=False,
                                  seed=4)
        iq = synth.u8_to_float(res.iq_u8)
        p = anim.animate_psd(iq, 0, arm="fm_demod",
                             out_path=str(tmp_path / "psd.gif"),
                             max_blocks=3)
        assert os.path.getsize(p) > 5000


class TestPlots:
    def test_psd_and_constellation_pngs(self, tmp_path):
        from sdr_fm.utils import plotting
        x = gen.add_sin(240e3, [19e3, 38e3], 8192)
        p1 = plotting.save_psd_png(str(tmp_path / "psd.png"), x, 240e3)
        p2 = plotting.save_constellation_png(
            str(tmp_path / "c.png"),
            np.random.default_rng(0).normal(size=200),
            np.random.default_rng(1).normal(size=200))
        assert os.path.getsize(p1) > 1000 and os.path.getsize(p2) > 1000
