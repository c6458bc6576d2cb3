"""Native host runtime vs numpy oracle (conversion semantics + threaded
block feed)."""

import os

import numpy as np
import pytest

native = pytest.importorskip("sdr_fm.native")


class TestConversions:
    def test_u8_normalize_matches_numpy(self):
        raw = np.arange(256, dtype=np.uint8)
        np.testing.assert_allclose(
            native.u8_normalize(raw),
            (raw.astype(np.float32) - 128.0) / 128.0)

    def test_pcm_quantize_matches_reference_semantics(self):
        x = np.array([0.0, np.nan, 0.5, -0.5, 3.0, -3.0], dtype=np.float32)
        y = native.pcm_quantize(x)
        assert list(y) == [0, 0, 8192, -8192, 32767, -32768]


class TestBlockReader:
    def test_feeds_all_blocks_and_drops_tail(self, tmp_path):
        rng = np.random.default_rng(0)
        data = rng.integers(0, 256, 10 * 4096 + 100, dtype=np.uint8)
        p = tmp_path / "iq.raw"
        data.tofile(p)

        fd = os.open(str(p), os.O_RDONLY)
        reader = native.BlockReader(fd, 4096, capacity=4)
        blocks = list(reader)
        os.close(fd)
        assert len(blocks) == 10
        expected = (data[:10 * 4096].astype(np.float32) - 128.0) / 128.0
        np.testing.assert_allclose(np.concatenate(blocks), expected)

    def test_raw_mode_yields_bytes(self, tmp_path):
        """raw=True (the CLI serving path) must hand back the exact
        file bytes as uint8 blocks for on-device normalization."""
        rng = np.random.default_rng(1)
        data = rng.integers(0, 256, 5 * 2048 + 7, dtype=np.uint8)
        p = tmp_path / "iq.raw"
        data.tofile(p)
        fd = os.open(str(p), os.O_RDONLY)
        reader = native.BlockReader(fd, 2048, capacity=3, raw=True)
        blocks = list(reader)
        os.close(fd)
        assert len(blocks) == 5
        assert all(b.dtype == np.uint8 for b in blocks)
        np.testing.assert_array_equal(np.concatenate(blocks),
                                      data[:5 * 2048])

    def test_pipe_streaming(self):
        """Producer thread keeps reading from a pipe while the consumer is
        slow — the decoupling the reference's queue provided."""
        r_fd, w_fd = os.pipe()
        payload = np.full(3 * 1000, 200, dtype=np.uint8)
        os.write(w_fd, payload.tobytes())
        os.close(w_fd)
        reader = native.BlockReader(r_fd, 1000, capacity=2)
        got = list(reader)
        os.close(r_fd)
        assert len(got) == 3
        np.testing.assert_allclose(got[0], (200.0 - 128.0) / 128.0)
