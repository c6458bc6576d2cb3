"""SNR robustness gates (SURVEY.md §4.3-4.4).

Two layers:

* the committed artifact ``docs/snr_matrix.json`` (produced by
  ``scripts/snr_matrix.py`` over the full 6-level x 1.2 s matrix) is
  schema- and monotonicity-gated across ALL levels for BOTH CDR
  algorithms, and
* a reduced live matrix (3 levels, shorter capture) re-measures the
  endpoints in-process so the artifact can never silently go stale
  against the code.

The reference's only robustness tooling was visual constellation
inspection (model/fmRDS.py:140-142,305-307); these gates quantify it.
"""

import json
import os

import numpy as np
import pytest

from sdr_fm import config as cfg
from sdr_fm.models import rds_decode, rds_groups
from sdr_fm.models.receiver import Receiver
from sdr_fm.utils import metrics, synth

ARTIFACT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "docs", "snr_matrix.json")
TONE_L, TONE_R = 800.0, 1500.0


class TestArtifact:
    """Gate the committed full-matrix artifact."""

    @pytest.fixture(scope="class")
    def matrix(self):
        assert os.path.exists(ARTIFACT), \
            "docs/snr_matrix.json missing - run scripts/snr_matrix.py"
        with open(ARTIFACT) as f:
            return json.load(f)

    def test_schema_and_levels(self, matrix):
        rows = matrix["rows"]
        assert [r["noise_std"] for r in rows] == [0.0, 0.02, 0.05, 0.1,
                                                  0.2, 0.4, 0.5, 0.63]
        for r in rows:
            for k in ("separation_db_l", "separation_db_r",
                      "mono_tone_snr_db", "rds_robust", "rds_reference",
                      "rds_robust_ec"):
                assert k in r, k

    @staticmethod
    def _row(matrix, noise):
        return next(r for r in matrix["rows"] if r["noise_std"] == noise)

    def test_clean_signal_quality(self, matrix):
        r0 = matrix["rows"][0]
        assert r0["separation_db_l"] > 30 and r0["separation_db_r"] > 30
        assert r0["mono_tone_snr_db"] > 24
        assert r0["rds_robust"]["word_accuracy"] == 1.0
        assert r0["rds_robust"]["pi_ok"] and r0["rds_robust"]["ps_ok"]

    def test_degradation_is_graceful(self, matrix):
        """Noise hurts, but the decoder degrades — it does not cliff."""
        rows = matrix["rows"]
        # mono SNR strictly loses ground from clean to the worst level
        assert rows[-1]["mono_tone_snr_db"] < rows[0]["mono_tone_snr_db"]
        r04 = self._row(matrix, 0.4)
        # stereo separation still usable at noise_std=0.4
        assert r04["separation_db_l"] > 25
        # robust CDR keeps >90% word accuracy at noise_std=0.4
        assert r04["rds_robust"]["word_accuracy"] > 0.9

    def test_robust_algo_dominates_reference(self, matrix):
        """The restart-free CDR must beat the reference-faithful CDR at
        EVERY noise level (it exists to be the production default)."""
        for r in matrix["rows"]:
            assert (r["rds_robust"]["word_accuracy"]
                    >= r["rds_reference"]["word_accuracy"]), r["noise_std"]
            # frame-count dominance only where frames still carry data:
            # past the decode floor (accuracy < 0.5) the reference CDR's
            # restart heuristic emits garbage syncs, and out-counting
            # garbage is not a virtue
            if r["rds_robust"]["word_accuracy"] >= 0.5:
                assert (r["rds_robust"]["frames"]
                        >= r["rds_reference"]["frames"]), r["noise_std"]

    def test_error_correction_extends_noise_floor(self, matrix):
        """The burst-<=5 correction must measurably
        extend frame recovery below the exact-match threshold: the
        perfect-word-accuracy level moves from noise_std=0.2 (exact) to
        0.4 (corrected) — a 20*log10(0.4/0.2) = 6 dB extension, beating
        the >=2 dB target and the reference's exact-match framesync."""
        for r in matrix["rows"]:
            ec, plain = r["rds_robust_ec"], r["rds_robust"]
            assert ec["frames"] >= plain["frames"], r["noise_std"]
        r02, r04 = self._row(matrix, 0.2), self._row(matrix, 0.4)
        assert r02["rds_robust"]["word_accuracy"] == 1.0
        assert r04["rds_robust"]["word_accuracy"] < 1.0    # exact drops
        assert r04["rds_robust_ec"]["word_accuracy"] == 1.0  # EC holds
        assert r04["rds_robust_ec"]["corrected"] > 0
        # deep-noise levels: correction still recovers extra frames
        r05 = self._row(matrix, 0.5)
        assert (r05["rds_robust_ec"]["frames"]
                > r05["rds_robust"]["frames"])


class TestLiveEndpoints:
    """Re-measure the matrix endpoints in-process (reduced duration)."""

    @pytest.fixture(scope="class")
    def levels(self):
        mc = cfg.get_mode_config(0)
        out = {}
        for noise in (0.0, 0.4):
            res = synth.synthesize_fm(
                duration_s=0.9, mode=0, seed=3, tone_l=TONE_L,
                tone_r=TONE_R, with_rds=True, noise_std=noise)
            rx = Receiver(0, stereo=True, with_rds=True)
            o = rx.run(res.iq_u8)
            left = np.asarray(o.left).reshape(-1)
            right = np.asarray(o.right).reshape(-1)
            mono = np.asarray(o.mono).reshape(-1)
            sep = metrics.stereo_separation_db(left, right, mc.audio_fs,
                                               TONE_L, TONE_R)
            snr = metrics.tone_snr_db(mono[6000:], mc.audio_fs, TONE_L,
                                      exclude=(TONE_R,))
            accs = {}
            for algo, fn in (("robust", rds_decode.decode_robust),
                             ("reference", rds_decode.decode_reference)):
                syms = np.asarray(o.rds_symbols)
                dec = fn(syms.reshape(-1) if algo == "robust" else syms,
                         mc.rds.sps)
                h, t = metrics.rds_accuracy(dec.info_words,
                                            res.rds_info_bits)
                accs[algo] = h / max(t, 1)
            out[noise] = dict(sep=sep, snr=snr, accs=accs)
        return out

    def test_clean(self, levels):
        clean = levels[0.0]
        assert min(clean["sep"]) > 30
        assert clean["snr"] > 24
        assert clean["accs"]["robust"] > 0.99

    def test_noisy_degrades_not_cliffs(self, levels):
        noisy = levels[0.4]
        assert levels[0.0]["snr"] - noisy["snr"] > 2.0  # noise measurable
        assert min(noisy["sep"]) > 25                    # still stereo
        assert noisy["accs"]["robust"] > 0.85            # still decoding
        assert noisy["accs"]["robust"] >= noisy["accs"]["reference"]
