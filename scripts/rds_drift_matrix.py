"""Long-form +-50 ppm clock-drift demonstration.

At 50 ppm the transmit symbol clock slips one full symbol (and flips the
Manchester pairing parity, killing any fixed-phase decoder) about 8.4 s
into a capture.  This script synthesizes 9 s +-50 ppm master-clock-drifted
stations (with noise), decodes them with the fixed-phase robust CDR and
the windowed tracking CDR (the streaming decoder's algo="tracking"), and
emits docs/rds_drift.json.  The fast-suite version of the same physics
(at +-400 ppm) is tests/test_rds_drift.py.

    python scripts/rds_drift_matrix.py
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
from sdr_fm.models import rds_decode  # noqa: E402
from sdr_fm.models.receiver import Receiver  # noqa: E402
from sdr_fm.utils import metrics, synth  # noqa: E402

DURATION_S = 9.0
NOISE = 0.1
WINDOW = 256


def run_ppm(ppm: float) -> dict:
    res = synth.synthesize_fm(duration_s=DURATION_S, mode=0, seed=7,
                              with_rds=True, clock_ppm=ppm,
                              noise_std=NOISE)
    rx = Receiver(0, stereo=True, with_rds=True)
    outs = rx.run(res.iq_u8)
    symbols = np.asarray(outs.rds_symbols)
    sps = cfg.get_mode_config(0).rds.sps
    flat = symbols.reshape(-1)
    n_sent = int(res.rds_info_bits.shape[0]) * 4
    row = {"clock_ppm": ppm, "frames_sent": n_sent}
    for label, kw in (("fixed_phase", {}),
                      ("tracking", {"window_symbols": WINDOW})):
        dec = rds_decode.decode_robust(flat, sps, **kw)
        h, t = metrics.rds_accuracy(dec.info_words, res.rds_info_bits)
        row[label] = {"frames": len(dec.frames.matches),
                      "word_accuracy": round(h / max(t, 1), 4)}
    # streaming tracking decoder (the CLI --rds-algo tracking path)
    dec = rds_decode.StreamingRdsDecoder(sps, algo="tracking",
                                         window_symbols=WINDOW)
    for blk in symbols:
        dec.feed(blk)
    dec.flush()
    row["streaming_tracking_frames"] = dec.n_matches
    return row


def main() -> int:
    rows = [run_ppm(p)
            for p in (50.0, -50.0, 100.0, -100.0, 200.0, -200.0, 0.0)]
    for r in rows:
        print(f"ppm={r['clock_ppm']:+6.1f}: sent {r['frames_sent']}, "
              f"fixed {r['fixed_phase']['frames']} "
              f"(acc {r['fixed_phase']['word_accuracy']:.3f}) vs tracking "
              f"{r['tracking']['frames']} "
              f"(acc {r['tracking']['word_accuracy']:.3f}); streaming "
              f"{r['streaming_tracking_frames']}", flush=True)
    out = {"duration_s": DURATION_S, "noise_std": NOISE,
           "window_symbols": WINDOW, "mode": 0, "rows": rows}
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "docs", "rds_drift.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
