"""SNR robustness matrix (SURVEY.md §4.3-4.4).

Sweeps input noise over a range of levels and measures, per level:
stereo separation (L and R), mono tone SNR, and RDS info-word accuracy
for BOTH symbol-clock recovery algorithms (robust restart-free CDR vs
the reference-faithful CDR).  Emits docs/snr_matrix.json and a printed
sensitivity table; tests/test_snr_matrix.py gates the curve.

    python scripts/snr_matrix.py
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from sdr_fm import config as cfg  # noqa: E402
from sdr_fm.models import rds_decode, rds_groups  # noqa: E402
from sdr_fm.models.receiver import Receiver  # noqa: E402
from sdr_fm.utils import metrics, synth  # noqa: E402

LEVELS = (0.0, 0.02, 0.05, 0.1, 0.2, 0.4, 0.5, 0.63)
TONE_L, TONE_R = 800.0, 1500.0


def run_level(noise_std: float, duration_s: float = 1.2,
              seed: int = 3) -> dict:
    mc = cfg.get_mode_config(0)
    station = synth.StationConfig(pi=0x54B1, pty=9, ps="JAX8 FM ",
                                  radiotext="HELLO JAX!", tp=True)
    res = synth.synthesize_fm(duration_s=duration_s, mode=0, seed=seed,
                              tone_l=TONE_L, tone_r=TONE_R,
                              with_rds=True, noise_std=noise_std,
                              rds_station=station)
    rx = Receiver(0, stereo=True, with_rds=True)
    outs = rx.run(res.iq_u8)
    left = np.asarray(outs.left).reshape(-1)
    right = np.asarray(outs.right).reshape(-1)
    mono = np.asarray(outs.mono).reshape(-1)
    sep_l, sep_r = metrics.stereo_separation_db(left, right, mc.audio_fs,
                                                TONE_L, TONE_R)
    # mono = (L+R)/2 carries BOTH tones: exclude the R tone's band from
    # the noise estimate or the metric saturates at ~0 dB at every level
    snr_mono = metrics.tone_snr_db(mono[6000:], mc.audio_fs, TONE_L,
                                   exclude=(TONE_R,))

    syms = np.asarray(outs.rds_symbols)
    row = {"noise_std": noise_std,
           "separation_db_l": round(float(sep_l), 1),
           "separation_db_r": round(float(sep_r), 1),
           "mono_tone_snr_db": round(float(snr_mono), 1)}
    decoders = (
        ("robust", lambda s: rds_decode.decode_robust(
            s.reshape(-1), mc.rds.sps)),
        ("reference", lambda s: rds_decode.decode_reference(s, mc.rds.sps)),
        # burst-<=5 error correction while synchronized (r5; capability
        # the reference's exact-match framesync lacks): recovers frames
        # at the noise floor — the frame-recovery threshold extension
        ("robust_ec", lambda s: rds_decode.decode_robust(
            s.reshape(-1), mc.rds.sps, error_correction=True)),
    )
    for algo, fn in decoders:
        dec = fn(syms)
        hits, total = metrics.rds_accuracy(dec.info_words,
                                           res.rds_info_bits)
        st = rds_groups.decode_station_from(dec)
        row[f"rds_{algo}"] = {
            "frames": len(dec.frames.matches),
            "word_accuracy": round(hits / max(total, 1), 4),
            "pi_ok": st.pi == 0x54B1,
            "ps_ok": st.ps_name == "JAX8 FM ",
        }
        if algo == "robust_ec":
            row[f"rds_{algo}"]["corrected"] = dec.n_corrected
    return row


def main() -> int:
    rows = [run_level(n) for n in LEVELS]
    for r in rows:
        print(f"noise={r['noise_std']:4.2f}: sep L/R "
              f"{r['separation_db_l']:5.1f}/{r['separation_db_r']:5.1f} dB,"
              f" mono SNR {r['mono_tone_snr_db']:5.1f} dB, RDS acc "
              f"robust {r['rds_robust']['word_accuracy']:.3f} "
              f"({r['rds_robust']['frames']} fr) / reference "
              f"{r['rds_reference']['word_accuracy']:.3f} "
              f"({r['rds_reference']['frames']} fr)", flush=True)
    out = {"mode": 0, "duration_s": 1.2, "tones_hz": [TONE_L, TONE_R],
           "noise_model": "AWGN std on unit-scale IQ before u8 quantize",
           "rows": rows}
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "docs", "snr_matrix.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
