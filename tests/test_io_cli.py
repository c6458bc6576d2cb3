"""IO layer semantics + CLI end-to-end (file in, PCM/wav out, RDS report)."""

import io as pyio
import os
import subprocess
import sys

import numpy as np
import pytest

from sdr_fm import config as cfg
from sdr_fm import io as sio
from sdr_fm.utils import synth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestIo:
    def test_u8_normalize_matches_reference_formula(self):
        raw = np.array([0, 127, 128, 255], dtype=np.uint8)
        np.testing.assert_allclose(
            sio.u8_normalize(raw),
            [(0 - 128) / 128, (127 - 128) / 128, 0.0, (255 - 128) / 128])

    def test_block_iterator_drops_short_tail(self):
        data = bytes(range(10)) * 10  # 100 bytes
        blocks = list(sio.iter_iq_blocks(pyio.BytesIO(data), 40))
        assert len(blocks) == 2
        assert all(len(b) == 40 for b in blocks)

    def test_pcm_quantize_nan_clamp(self):
        x = np.array([0.0, np.nan, 0.5, -0.5, 1.5], dtype=np.float32)
        y = sio.pcm_quantize(x)
        assert y.dtype == np.int16
        assert y[1] == 0
        assert y[2] == 8192 and y[3] == -8192

    def test_f32_roundtrip(self, tmp_path):
        x = np.random.default_rng(0).normal(size=64).astype(np.float32)
        p = str(tmp_path / "x.bin")
        sio.write_f32(p, x)
        np.testing.assert_array_equal(sio.read_f32(p), x)

    @pytest.mark.parametrize("channels", [1, 2])
    def test_streaming_wav_byte_identical_to_write_wav(self, tmp_path,
                                                       channels):
        """The incremental writer (the CLI's --wav path, single-station
        AND wideband) produces byte-identical files to accumulate +
        write_wav, in per-block chunks."""
        rng = np.random.default_rng(5)
        shape = (3000,) if channels == 1 else (3000, channels)
        audio = rng.uniform(-1, 1, shape).astype(np.float32)
        ref = str(tmp_path / "ref.wav")
        sio.write_wav(ref, audio, 48000)
        inc = str(tmp_path / "inc.wav")
        with sio.StreamingWavWriter(inc, 48000, channels=channels) as w:
            for k in range(0, 3000, 700):
                w.write(audio[k:k + 700])
        with open(ref, "rb") as f1, open(inc, "rb") as f2:
            assert f1.read() == f2.read()


class TestCli:
    @pytest.fixture(scope="class")
    def raw_file(self, tmp_path_factory):
        d = tmp_path_factory.mktemp("cli")
        res = synth.synthesize_fm(duration_s=0.2, mode=0, with_stereo=True,
                                  with_rds=True, seed=13)
        p = d / "station.raw"
        res.iq_u8.tofile(p)
        return str(p), res

    def _run(self, args):
        return subprocess.run(
            [sys.executable, "-m", "sdr_fm.cli", *args],
            capture_output=True, timeout=600,
            env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
                 "PYTHONPATH": REPO, "HOME": os.environ.get("HOME", REPO)})

    def test_mono_pcm_stdout(self, raw_file):
        path, _ = raw_file
        r = self._run(["--mode", "0", path, "--stats"])
        assert r.returncode == 0, r.stderr.decode()
        pcm = np.frombuffer(r.stdout, dtype=np.int16)
        mc = cfg.get_mode_config(0)
        # ~0.2 s of audio at 48 kHz (block-quantized)
        assert len(pcm) > 0.15 * mc.audio_fs
        assert np.abs(pcm.astype(np.int32)).max() > 1000  # real audio
        assert b"MS/s" in r.stderr

    def test_checkpoint_resume_splits_identically(self, raw_file, tmp_path):
        """Processing a file in two CLI invocations with --save-state /
        --resume yields byte-identical PCM to one invocation."""
        path, _ = raw_file
        mc = cfg.get_mode_config(0)
        bs = mc.default_block_size(False)
        data = np.fromfile(path, dtype=np.uint8)
        n2 = 2 * bs
        p1, p2 = tmp_path / "a.raw", tmp_path / "b.raw"
        data[:n2].tofile(p1)
        data[n2:].tofile(p2)
        st = str(tmp_path / "ck.npz")

        full = self._run(["--mode", "0", path])
        assert full.returncode == 0, full.stderr.decode()

        r1 = self._run(["--mode", "0", str(p1), "--save-state", st])
        r2 = self._run(["--mode", "0", str(p2), "--resume", st])
        assert r1.returncode == 0 and r2.returncode == 0, r2.stderr.decode()
        assert r1.stdout + r2.stdout == full.stdout

    def test_inflight_depth_output_invariant(self, raw_file):
        """The in-order fetch pipeline (r5) must emit a byte-identical
        stream at any --inflight depth (ordering is the correctness
        contract of the overlapped fetches)."""
        path, _ = raw_file
        base = self._run(["--mode", "0", "--stereo", path,
                          "--inflight", "1"])
        deep = self._run(["--mode", "0", "--stereo", path,
                          "--inflight", "16"])
        assert base.returncode == 0 and deep.returncode == 0, \
            deep.stderr.decode()
        assert base.stdout == deep.stdout
        assert len(base.stdout) > 0

    def test_stereo_wav_and_rds(self, raw_file, tmp_path):
        path, res = raw_file
        out = str(tmp_path / "out.wav")
        r = self._run(["--mode", "0", "--stereo", "--rds", path,
                       "--wav", "-o", out])
        assert r.returncode == 0, r.stderr.decode()
        from scipy.io import wavfile
        fs, audio = wavfile.read(out)
        assert fs == 48000 and audio.ndim == 2 and audio.shape[1] == 2
        assert b"RDS:" in r.stderr and b"frames" in r.stderr
