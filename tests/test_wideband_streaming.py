"""Streaming wideband CLI: incremental wav, per-station RDS, resume-exact.

The wideband path previously accumulated every block's audio/symbols in
host lists and decoded RDS only at EOF; now it streams —
io.StreamingWavWriter writes per block, each station owns a
StreamingRdsDecoder fed per block, and --save-state/--resume round-trips
the channelizer carry + the batched receiver pytree + every station's RDS
carry.  These tests gate:

* the incremental wav writer is byte-identical to the one-shot writer,
* a split run (--save-state at block k, --resume for the rest) produces
  bit-identical wavs and the same RDS frame streams as the uninterrupted
  run.
"""

import subprocess
import sys

import numpy as np
import pytest

from sdr_fm import io as sio
from sdr_fm.utils import synth

CLI_ENV = {"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": "/root/repo", "HOME": "/root"}


class TestStreamingWavWriter:
    @pytest.mark.parametrize("channels", [1, 2])
    def test_matches_oneshot_writer(self, tmp_path, channels):
        rng = np.random.default_rng(0)
        audio = rng.normal(scale=0.3, size=(4096, channels)).astype(
            np.float32)
        if channels == 1:
            audio = audio[:, 0]
        one = tmp_path / "one.wav"
        inc = tmp_path / "inc.wav"
        sio.write_wav(str(one), audio, 48000)
        with sio.StreamingWavWriter(str(inc), 48000, channels) as w:
            for k in range(0, 4096, 600):   # ragged chunking
                w.write(audio[k:k + 600])
        assert one.read_bytes() == inc.read_bytes()

    def test_header_patched(self, tmp_path):
        p = tmp_path / "x.wav"
        with sio.StreamingWavWriter(str(p), 44100, 1) as w:
            w.write(np.zeros(100, np.float32))
            w.write(np.ones(50, np.float32))
        from scipy.io import wavfile
        fs, data = wavfile.read(str(p))
        assert fs == 44100 and len(data) == 150
        assert data[-1] == 16384  # full-scale factor


@pytest.fixture(scope="module")
def wideband():
    return synth.synthesize_wideband(
        duration_s=0.45, fs_wide=9.6e6, offsets_hz=[-1.5e6, 2.0e6],
        mode=0, seed=3, with_rds=True)


def _run_cli(raw_path, prefix, extra=()):
    r = subprocess.run(
        [sys.executable, "-m", "sdr_fm.cli", "--mode", "0", "--stereo",
         "--rds", "--wideband", "9600000", "--offsets=-1500000,2000000",
         str(raw_path), "--wav", "-o", str(prefix), *extra],
        capture_output=True, timeout=900, env=CLI_ENV)
    assert r.returncode == 0, r.stderr.decode()[:500]
    return r.stderr.decode()


class TestWidebandResume:
    def test_split_run_bit_identical(self, wideband, tmp_path):
        from sdr_fm import config as cfg
        mc = cfg.get_mode_config(0)
        bs_wide = mc.default_block_size(True) * 4   # decim 9.6e6/2.4e6
        iq = wideband.iq_u8
        n_blocks = len(iq) // bs_wide
        assert n_blocks >= 4, n_blocks
        k = n_blocks // 2

        full_raw = tmp_path / "full.raw"
        iq[: n_blocks * bs_wide].tofile(full_raw)
        a_raw = tmp_path / "a.raw"
        iq[: k * bs_wide].tofile(a_raw)
        b_raw = tmp_path / "b.raw"
        iq[k * bs_wide: n_blocks * bs_wide].tofile(b_raw)

        # uninterrupted
        err_full = _run_cli(full_raw, tmp_path / "full")
        # split with checkpoint between
        ck = tmp_path / "ck.npz"
        _run_cli(a_raw, tmp_path / "partA", ("--save-state", str(ck)))
        err_b = _run_cli(b_raw, tmp_path / "partB", ("--resume", str(ck)))

        for st in range(2):
            full = (tmp_path / f"full_{st}.wav").read_bytes()
            pa = (tmp_path / f"partA_{st}.wav").read_bytes()
            pb = (tmp_path / f"partB_{st}.wav").read_bytes()
            # strip 44-byte headers, concatenate PCM payloads
            assert pa[44:] + pb[44:] == full[44:], f"station {st}"

        # the resumed run's cumulative RDS frame counts match the
        # uninterrupted run's (frame stream is continued, not restarted)
        import re
        full_counts = re.findall(r"RDS (\d+) frames", err_full)
        b_counts = re.findall(r"RDS (\d+) frames", err_b)
        assert full_counts == b_counts and len(full_counts) == 2, \
            (full_counts, b_counts)
        # station identification survives the split
        for line_set in (err_full, err_b):
            assert "PI=" in line_set

    def test_resume_warns_on_algo_mismatch(self, wideband, tmp_path):
        from sdr_fm import config as cfg
        mc = cfg.get_mode_config(0)
        bs_wide = mc.default_block_size(True) * 4
        iq = wideband.iq_u8
        a_raw = tmp_path / "a.raw"
        iq[:2 * bs_wide].tofile(a_raw)
        ck = tmp_path / "ck.npz"
        _run_cli(a_raw, tmp_path / "w", ("--save-state", str(ck)))
        err = _run_cli(a_raw, tmp_path / "w2",
                       ("--resume", str(ck), "--rds-algo", "reference"))
        assert "ignored" in err and "robust" in err
