"""Characterize time-shard stereo error vs overlap length.

The time-sharded receiver re-locks each shard's PLL during a discarded
input overlap (docs/DESIGN.md §3); the linear arms are bit-exact for any
overlap >= FIR depth, so the overlap length only buys PLL convergence.
This script measures the kept-region RMS error of the stereo L arm vs the
contiguous run, per overlap length, on the 8-virtual-device CPU mesh —
the curve that justifies the default overlap.

    python scripts/overlap_convergence.py  ->  prints table, writes
                                               docs/overlap_convergence.json
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from sdr_fm import config as cfg  # noqa: E402
from sdr_fm.models import receiver as trx  # noqa: E402
from sdr_fm.parallel import time_shard  # noqa: E402
from sdr_fm.utils import synth  # noqa: E402


def main() -> int:
    mc = cfg.get_mode_config(0)
    s = 8
    block_if = time_shard.default_block_if(mc, False)
    gran = block_if * 2 * mc.rf_decim
    mesh = Mesh(np.array(jax.devices()[:s]), ("time",))

    rows = []
    for noise_std in (0.0, 0.02, 0.1):
        res = synth.synthesize_fm(duration_s=2.4, mode=0, with_stereo=True,
                                  with_rds=False, seed=21,
                                  noise_std=noise_std)
        iq = synth.u8_to_float(res.iq_u8)
        seg = (iq.shape[-1] // s) // gran * gran
        iq = iq[: seg * s]

        rxs = trx.Receiver(0, stereo=True)
        ref = rxs.run(iq, block_size=iq.shape[-1])
        left_ref = np.asarray(ref.left).reshape(-1)
        ref_rms = float(np.sqrt(np.mean(left_ref**2)))

        for n_blocks in (1, 2, 3, 4, 6, 8, 12):
            overlap_if = n_blocks * block_if
            outs = time_shard.time_sharded_receive(
                iq, mesh, 0, stereo=True, with_rds=False,
                overlap_if=overlap_if)
            left = np.asarray(outs.left)
            per_shard = (left - left_ref).reshape(s, -1)
            # shard 0 is exact (fresh-state reset); the PLL-relock error
            # lives in shards 1..S-1
            rel = [float(np.sqrt(np.mean(e**2)) / ref_rms)
                   for e in per_shard]
            worst = max(rel[1:])
            rows.append({
                "noise_std": noise_std,
                "overlap_blocks": n_blocks,
                "overlap_if_samples": overlap_if,
                "overlap_ms": overlap_if / mc.if_fs * 1e3,
                "shard0_rel_rms": rel[0],
                "worst_other_shard_rel_rms": worst,
                "mean_other_shard_rel_rms": float(np.mean(rel[1:])),
            })
            print(f"noise={noise_std:4.2f} overlap={n_blocks:2d} blk "
                  f"({overlap_if:6d} IF, {rows[-1]['overlap_ms']:6.1f} ms):"
                  f" worst shard rel-RMS {worst:.2e}, shard0 {rel[0]:.2e}",
                  flush=True)

    out = {
        "mode": 0, "shards": s, "block_if": block_if,
        "metric": "per-shard kept-region RMS(left - contiguous)/RMS(left)",
        "rows": rows,
    }
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "docs", "overlap_convergence.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
