"""Long-capture demo: stream a >=60 s synthetic FM capture through the
receiver with O(chunk) memory (BASELINE.json's
pod-scale config names a 1-hour capture that the stacked outputs of
``Receiver.run`` would not hold).

Synthesizes a 2 s station, tiles it to the requested duration (the tile
seam is an FM-continuous point only approximately — irrelevant for a
memory/throughput demo), then streams it through ``Receiver.iter_run``
writing PCM to disk per chunk.  Reports wall time, throughput, peak RSS,
and the largest single device allocation implied by the chunk size.

    python scripts/long_capture_demo.py [--duration 60] [--chunk-blocks 64]
"""

from __future__ import annotations

import argparse
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--duration", type=float, default=60.0)
    ap.add_argument("--chunk-blocks", type=int, default=64)
    ap.add_argument("--out", default="/tmp/long_capture.pcm")
    ap.add_argument("--cpu", action="store_true", help="pin to CPU")
    a = ap.parse_args(argv)

    import jax
    if a.cpu:
        jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from sdr_fm import config as cfg
    from sdr_fm.models.receiver import Receiver
    from sdr_fm.utils import synth
    from sdr_fm.io import pcm_quantize

    mc = cfg.get_mode_config(0)
    bs = mc.default_block_size(False)

    base = synth.synthesize_fm(duration_s=2.0, mode=0, seed=1,
                               with_stereo=True, with_rds=False).iq_u8
    reps = int(np.ceil(a.duration * mc.rf_fs * 2 / len(base)))
    iq = np.tile(base, reps)
    n_blocks = len(iq) // bs
    dur = len(iq) / 2 / mc.rf_fs
    print(f"capture: {dur:.1f} s, {len(iq) / 1e6:.0f} MB u8, "
          f"{n_blocks} blocks of {bs // 2} IQ pairs, "
          f"chunk={a.chunk_blocks} blocks", file=sys.stderr)

    rx = Receiver(0, stereo=True, with_rds=False)
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    t0 = time.time()
    written = 0
    with open(a.out, "wb") as f:
        for outs in rx.iter_run(iq, chunk_blocks=a.chunk_blocks):
            audio = np.stack([outs.left.reshape(-1),
                              outs.right.reshape(-1)], axis=-1)
            buf = pcm_quantize(audio).tobytes()
            f.write(buf)
            written += len(buf)
    dt = time.time() - t0
    rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss

    msps = len(iq) / 2 / dt / 1e6
    print(f"done: {dt:.1f} s wall ({msps:.1f} MS/s, "
          f"{dur / dt:.1f}x realtime), {written / 1e6:.0f} MB PCM out, "
          f"peak RSS {rss1 / 1024:.0f} MB (delta during run "
          f"{(rss1 - rss0) / 1024:.0f} MB)", file=sys.stderr)
    chunk_mb = a.chunk_blocks * bs * 4 / 1e6
    print(f"device residency per dispatch: ~{chunk_mb:.1f} MB input "
          f"chunk + O(chunk) outputs — independent of the "
          f"{len(iq) / 1e6:.0f} MB capture", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
