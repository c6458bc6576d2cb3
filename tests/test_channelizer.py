"""Wideband channelizer -> batched receiver end-to-end.

Two stations synthesized at carrier offsets in one 9.6 MS/s capture must
both demodulate with correct per-station tones and RDS data after
channelization into the channel-parallel batch.
"""

import numpy as np
import pytest

from sdr_fm import config as cfg
from sdr_fm.models import rds_decode
from sdr_fm.models import receiver as trx
from sdr_fm.models.channelizer import Channelizer
from sdr_fm.utils import metrics, synth


@pytest.fixture(scope="module")
def wideband():
    return synth.synthesize_wideband(
        duration_s=0.3, fs_wide=9.6e6, offsets_hz=[-1.5e6, 2.0e6],
        mode=0, seed=3, with_rds=True)


class TestChannelizer:
    def test_two_stations_decode(self, wideband):
        mc = cfg.get_mode_config(0)
        ch = Channelizer(wideband.offsets_hz, wideband.fs_wide, 0)
        rx = trx.Receiver(0, stereo=True, with_rds=True, batch_shape=(2,))

        bs_wide = mc.default_block_size(True) * ch.decim
        iq = wideband.iq_u8
        n_blocks = len(iq) // bs_wide
        lefts, rights, syms = [], [], []
        for b in range(n_blocks):
            chan = ch.process(iq[b * bs_wide:(b + 1) * bs_wide])
            out = rx.process(chan)
            lefts.append(np.asarray(out.left))
            rights.append(np.asarray(out.right))
            syms.append(np.asarray(out.rds_symbols))
        left = np.concatenate(lefts, axis=-1)
        right = np.concatenate(rights, axis=-1)
        sym = np.concatenate(syms, axis=-1)

        for k in range(2):
            tone_l = 600.0 + 300.0 * k
            tone_r = 2300.0 - 400.0 * k
            sep_l, sep_r = metrics.stereo_separation_db(
                left[k], right[k], mc.audio_fs, tone_l, tone_r)
            assert sep_l > 15 and sep_r > 15, (k, sep_l, sep_r)
            dec = rds_decode.decode_robust(sym[k], mc.rds.sps)
            hits, total = metrics.rds_accuracy(
                dec.info_words, wideband.stations[k].rds_info_bits)
            assert total >= 6 and hits >= total - 1, (k, hits, total)

    def test_rejects_non_integer_decimation(self):
        with pytest.raises(ValueError):
            Channelizer([0.0], 5.0e6, 0)


class TestWidebandCli:
    def test_cli_wideband_two_stations(self, wideband, tmp_path):
        import subprocess
        import sys

        p = tmp_path / "wide.raw"
        wideband.iq_u8.tofile(p)
        prefix = str(tmp_path / "st")
        r = subprocess.run(
            [sys.executable, "-m", "sdr_fm.cli", "--mode", "0", "--stereo",
             "--rds", "--wideband", "9600000",
             "--offsets=-1500000,2000000", str(p), "--wav", "-o", prefix],
            capture_output=True, timeout=600,
            env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
                 "PYTHONPATH": "/root/repo", "HOME": "/root"})
        assert r.returncode == 0, r.stderr.decode()
        from scipy.io import wavfile
        for k in range(2):
            fs, audio = wavfile.read(f"{prefix}_{k}.wav")
            assert fs == 48000 and audio.shape[1] == 2
        assert r.stderr.count(b"RDS") == 2
