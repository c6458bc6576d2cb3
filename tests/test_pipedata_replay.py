"""Replay the reference's captured pipeline log.

``data/data/pipeData.txt`` is the only artifact in the reference repo
produced by its ACTUAL runs: a stderr capture of the real-time pipeline
processing a real 24 MS off-air RTL-SDR recording, in which
``printRealVectorFloat`` (src/threadMonoOnly.cpp:436-443) dumped two full
102,400-sample raw input blocks.  Every other crosscheck in this suite
runs on stations we synthesized ourselves; these tests replay the one
input vector we did NOT make:

* the printed floats reconstruct EXACTLY to u8 (they are
  ``(u8-128)/128``, src/iofunc.cpp:133) — proving they are raw antenna
  bytes, recoverable bit-perfectly;
* our golden front-end matches the EXECUTED upstream Python model on the
  real capture at 1e-9;
* our CLI's mono PCM matches the COMPILED reference C++ binary on the
  real capture within 1 LSB.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from sdr_fm.utils import pipedata

pytestmark = pytest.mark.skipif(
    not os.path.exists(pipedata.PIPEDATA_PATH),
    reason="reference checkout not present")


@pytest.fixture(scope="module")
def capture():
    return pipedata.parse()


class TestReconstruction:
    def test_log_shape(self, capture):
        assert capture.iq_data_size == 24_000_000
        assert capture.block_size == 102_400
        assert [len(b) for b in capture.blocks_u8] == [102_400, 102_400]

    def test_values_exactly_on_u8_grid(self, capture):
        """Every printed float is an exact multiple of 1/128 in [-1, 1) —
        the u8 normalization grid — so the reconstruction is lossless."""
        for f32, u8 in zip(capture.blocks_f32, capture.blocks_u8):
            back = (u8.astype(np.float64) - 128.0) / 128.0
            # the log prints 6 significant digits; on this grid that is
            # exact for all but trailing-zero truncation (<= 5e-7)
            np.testing.assert_allclose(back, f32, atol=5e-7)

    def test_looks_like_antenna_data(self, capture):
        """Real RTL-SDR captures are zero-mean (offset 128) and use a wide
        swath of the ADC range — unlike any constant/ramp test pattern."""
        for u8 in capture.blocks_u8:
            assert abs(float(u8.mean()) - 128.0) < 2.0
            assert u8.std() > 10.0
            assert len(np.unique(u8)) > 100


class TestGoldenVsExecutedUpstream:
    def test_frontend_on_real_capture(self, capture):
        """Golden front-end (block FIR + decim + demod) vs the executed
        upstream model functions on the real bytes, 1e-9."""
        import importlib.util
        ref_lib = "/root/reference/model/fmSupportLib.py"
        spec = importlib.util.spec_from_file_location("ref_fmSupportLib",
                                                      ref_lib)
        ref = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(ref)

        from sdr_fm import config as cfg
        from sdr_fm.golden import demod as gdemod
        from sdr_fm.golden import filters as gfilt

        mc = cfg.get_mode_config(0)
        h = gfilt.lowpass_taps(mc.rf_taps, mc.rf_fs, cfg.RF_FC_HZ)

        st_i = st_q = np.zeros(mc.rf_taps - 1)
        rst_i = rst_q = np.zeros(mc.rf_taps - 1)
        iq_state = np.zeros(2)
        ref_iq = np.array([0.0, 0.0])
        for u8 in capture.blocks_u8:
            x = (u8.astype(np.float32) - 128.0) / 128.0
            i_in, q_in = x[0::2].astype(np.float64), x[1::2].astype(
                np.float64)
            ours_i, st_i = gfilt.block_fir_decim(i_in, h, st_i, mc.rf_decim)
            ours_q, st_q = gfilt.block_fir_decim(q_in, h, st_q, mc.rf_decim)
            fm, iq_state = gdemod.fm_demod_quad(ours_i, ours_q, iq_state)

            theirs_i, rst_i = ref.convolveBlockFastFIR(i_in, h, rst_i,
                                                       mc.rf_decim)
            theirs_q, rst_q = ref.convolveBlockFastFIR(q_in, h, rst_q,
                                                       mc.rf_decim)
            ref_fm, ref_iq = ref.compEffDemod(theirs_i, theirs_q, ref_iq)

            np.testing.assert_allclose(ours_i, theirs_i, atol=1e-9)
            np.testing.assert_allclose(ours_q, theirs_q, atol=1e-9)
            np.testing.assert_allclose(fm, np.asarray(ref_fm), atol=1e-9)


class TestBinaryOnRealCapture:
    @pytest.fixture(scope="class")
    def ref_binary(self, tmp_path_factory):
        if shutil.which("g++") is None:
            pytest.skip("no C++ toolchain")
        exe = str(tmp_path_factory.mktemp("refbin") / "refMono")
        r = subprocess.run(
            ["g++", "-O3", "-pthread", "-std=c++11",
             "/root/reference/src/threadMonoOnly.cpp", "-o", exe],
            capture_output=True, timeout=300)
        if r.returncode != 0:
            pytest.skip(f"reference build failed: {r.stderr[:200]}")
        return exe

    def test_mono_pcm_within_one_lsb(self, capture, ref_binary, tmp_path):
        """The real-data analog of
        test_reference_crosscheck.TestReferenceBinary: same bytes, compiled
        reference binary vs our CLI, <=1 LSB.

        Gate detail: the capture is weak/noise-like, so the FM demod's
        1/(I^2+Q^2) occasionally spikes the audio beyond int16 full scale.
        There the reference's ``static_cast<short>(x * 16384)``
        (src/threadMonoOnly.cpp:189) is undefined behavior (it wraps on
        this toolchain) while we saturate — so the <=1 LSB gate applies
        where the float audio is int16-representable (~95% of samples
        here), with the out-of-range handling divergence documented in
        PARITY.md.  The in-range region is computed from our GOLDEN model,
        not from either binary's output, so the mask cannot hide a real
        mismatch."""
        from sdr_fm import config as cfg
        from sdr_fm.golden import receiver as gr

        raw = tmp_path / "pipedata.raw"
        iq = np.concatenate(capture.blocks_u8)
        iq.tofile(raw)

        with open(raw, "rb") as f:
            ref = subprocess.run([ref_binary, "0"], stdin=f,
                                 capture_output=True, timeout=300)
        ref_pcm = np.frombuffer(ref.stdout, dtype=np.int16).astype(float)
        assert len(ref_pcm) > 0, ref.stderr.decode()[:300]

        ours = subprocess.run(
            [sys.executable, "-m", "sdr_fm.cli", "--mode", "0",
             "--block-size", "102400", str(raw)],
            capture_output=True, timeout=500,
            env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
                 "PYTHONPATH": "/root/repo", "HOME": "/root"})
        assert ours.returncode == 0, ours.stderr.decode()[:300]
        our_pcm = np.frombuffer(ours.stdout, dtype=np.int16).astype(float)

        # golden-model float audio defines the int16-representable mask
        x = (iq.astype(np.float32) - 128.0) / 128.0
        mc = cfg.get_mode_config(0)
        outs = gr.run_file(x.astype(np.float64), mc, stereo=False,
                           block_size=102_400)
        scaled = np.concatenate([np.asarray(o.mono) for o in outs]) * 16384

        # our mono is delay-matched (+75 IF = 15 audio samples at decim
        # 10/5); the reference mono-only build applies no delay
        d = 15
        n = min(len(ref_pcm), len(our_pcm) - d)
        assert n > 900, (len(ref_pcm), len(our_pcm))
        mask = np.abs(scaled[d:d + n]) < 32_000
        assert mask.mean() > 0.85, mask.mean()
        err = np.abs(ref_pcm[:n] - our_pcm[d:d + n])[mask]
        assert err.max() <= 1 and err.mean() < 0.05, (err.max(), err.mean())
