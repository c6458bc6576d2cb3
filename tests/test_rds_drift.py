"""Clock-drift tolerance of the RDS symbol-clock recovery.

Real transmit oscillators drift ppm-scale against the receiver's sampling
grid; at 50 ppm the symbol phase walks one full sample every ~0.32 s
(sps=26 at 61.75 kS/s), so any fixed-phase decoder loses the symbol peaks
within a second.  A fixed-phase
decoder survives sub-symbol slip on clean signals (the RRC keeps the sign
right off-peak) but COLLAPSES once accumulated slip crosses a symbol
boundary and the Manchester pairing parity flips — at 50 ppm that is
~8.4 s into a capture (gated long-form by scripts/rds_drift_matrix.py ->
docs/rds_drift.json); these tests exercise the identical physics at
+-400 ppm where the flip lands at ~1.05 s, keeping the suite fast.  They
synthesize a master-clock-drifted station (pilot + subcarrier + symbol
clock together, like one crystal — utils/synth.py clock_ppm) and gate:

* the fixed-phase robust CDR degrades measurably on the drifted capture
  (the justification for the tracking algorithm existing),
* the windowed tracking CDR decodes it with ~full word accuracy, both
  offline and through StreamingRdsDecoder(algo="tracking"),
* streaming emits the identical bitstream as the offline
  ``decode_robust(window_symbols=...)`` path on full windows,
* the tracking carry is resume-exact through state_dict round-trips.
"""

import numpy as np
import pytest

from sdr_fm import config as cfg
from sdr_fm.golden import rds as grds
from sdr_fm.models import rds_decode
from sdr_fm.models.receiver import Receiver
from sdr_fm.utils import metrics, synth

PPM = 400.0
WINDOW = 256


@pytest.fixture(scope="module", params=[PPM, -PPM])
def drifted(request):
    res = synth.synthesize_fm(duration_s=2.2, mode=0, seed=7,
                              with_rds=True, clock_ppm=request.param,
                              noise_std=0.1)
    rx = Receiver(0, stereo=True, with_rds=True)
    outs = rx.run(res.iq_u8)
    return np.asarray(outs.rds_symbols), res


def _accuracy(dec, res):
    hits, total = metrics.rds_accuracy(dec.info_words, res.rds_info_bits)
    return hits / max(total, 1), total


class TestDriftOffline:
    def test_fixed_phase_degrades_tracking_recovers(self, drifted):
        symbols, res = drifted
        sps = cfg.get_mode_config(0).rds.sps
        flat = symbols.reshape(-1)

        fixed = rds_decode.decode_robust(flat, sps)
        track = rds_decode.decode_robust(flat, sps, window_symbols=WINDOW)
        acc_track, total = _accuracy(track, res)
        n_sent = res.rds_info_bits.shape[0] * 4

        # the parity flip kills the fixed-phase stream mid-capture: well
        # under 60% of transmitted frames survive
        assert len(fixed.frames.matches) < 0.6 * n_sent, \
            (len(fixed.frames.matches), n_sent)
        # windowed re-estimation recovers most frames at ~full accuracy
        assert len(track.frames.matches) > 0.8 * n_sent
        assert acc_track > 0.97, acc_track
        assert total > 50


class TestDriftStreaming:
    def test_streaming_matches_offline_tracking(self, drifted):
        """Block-fed tracking decoder emits the same manchester stream as
        offline cdr_tracking over the full-window prefix."""
        symbols, _ = drifted
        sps = cfg.get_mode_config(0).rds.sps
        flat = symbols.reshape(-1)

        dec = rds_decode.StreamingRdsDecoder(sps, algo="tracking",
                                             window_symbols=WINDOW)
        bits_stream = []
        for blk in symbols:
            bits_stream.append(dec._manchester_bits(
                np.asarray(blk, np.float64).reshape(-1)))
        got = np.concatenate(bits_stream)

        w = WINDOW * sps
        n_full = (len(flat) // w) * w
        want = grds.cdr_tracking(flat[:n_full], sps, WINDOW)
        np.testing.assert_array_equal(got, want)

    def test_streaming_tracking_decodes_drifted_capture(self, drifted):
        symbols, res = drifted
        sps = cfg.get_mode_config(0).rds.sps
        dec = rds_decode.StreamingRdsDecoder(sps, algo="tracking",
                                             window_symbols=WINDOW)
        for blk in symbols:
            dec.feed(blk)
        dec.flush()
        # frame count matches the offline tracking decode, whose word
        # accuracy the offline test already gates at >0.97
        track = rds_decode.decode_robust(symbols.reshape(-1), sps,
                                         window_symbols=WINDOW)
        assert dec.n_matches > 50
        assert abs(dec.n_matches - len(track.frames.matches)) <= 2, \
            (dec.n_matches, len(track.frames.matches))

    def test_tracking_resume_exact(self, drifted, tmp_path):
        """state_dict round-trip at an arbitrary block reproduces the
        uninterrupted frame stream exactly (incl. the sample window
        buffer and the timing-loop carry: pos/step/pairing)."""
        symbols, _ = drifted
        sps = cfg.get_mode_config(0).rds.sps

        base = rds_decode.StreamingRdsDecoder(sps, algo="tracking",
                                              window_symbols=WINDOW)
        matches_base = []
        for blk in symbols:
            matches_base += base.feed(blk)
        matches_base += base.flush()

        for split in (1, len(symbols) // 2, len(symbols) - 1):
            a = rds_decode.StreamingRdsDecoder(sps, algo="tracking",
                                               window_symbols=WINDOW)
            got = []
            for blk in symbols[:split]:
                got += a.feed(blk)
            arrays, meta = a.state_dict()
            # npz round-trip like the CLI checkpoint path
            import io as _io
            buf = _io.BytesIO()
            np.savez(buf, **arrays)
            buf.seek(0)
            arrays2 = dict(np.load(buf))
            b = rds_decode.StreamingRdsDecoder.load_state_dict(arrays2,
                                                               meta)
            for blk in symbols[split:]:
                got += b.feed(blk)
            got += b.flush()
            assert got == matches_base, split
            assert b.n_matches == base.n_matches


class TestDriftCli:
    def test_cli_tracking_on_drifted_capture(self, tmp_path):
        import subprocess
        import sys
        res = synth.synthesize_fm(duration_s=2.2, mode=0, seed=11,
                                  with_rds=True, clock_ppm=PPM,
                                  noise_std=0.1,
                                  rds_station=synth.StationConfig(
                                      pi=0x54B1, ps="DRIFT FM"))
        raw = tmp_path / "drift.raw"
        res.iq_u8.tofile(raw)
        r = subprocess.run(
            [sys.executable, "-m", "sdr_fm.cli", "--mode", "0", "--stereo",
             "--rds", "--rds-algo", "tracking", str(raw),
             "-o", str(tmp_path / "out.pcm")],
            capture_output=True, timeout=600,
            env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
                 "PYTHONPATH": "/root/repo", "HOME": "/root"})
        assert r.returncode == 0, r.stderr.decode()[:400]
        err = r.stderr.decode()
        assert "RDS:" in err
        import re
        m = re.search(r"RDS: (\d+) frames", err)
        assert m and int(m.group(1)) > 30, err
        assert "PI=54B1" in err, err
