"""Per-stage timing spans + analytical MAC accounting (SURVEY.md §5).

The reference wraps every pipeline stage in chrono spans accumulated into
per-stage totals (src/project.cpp:72-91,193-290) and reports MAC/sample
figures (report Tables 1-2, computed from tap counts and rate ratios;
``multCount`` instrumentation src/filter.cpp:164-215).  Here:

* ``StageTimer`` — context-manager spans with cumulative totals and a
  report() mirroring the reference's end-of-run printout.  Note: on a device,
  stages inside one jitted program are fused by XLA and cannot be timed
  individually from the host; StageTimer times host-visible units (whole
  blocks, IO, host decode).  For intra-program profiles use
  ``trace_to(dir)`` (jax.profiler) and the TensorBoard trace viewer.
* ``mac_per_audio_sample`` — the analytical MAC model reproducing report
  Table 1 exactly (1111/1313/~1200/~1567 mono, 2121/2525/~2300/~3033
  stereo for modes 0-3 at 101 taps) — our cost-model ground truth.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Iterator

from sdr_fm import config as cfg


class StageTimer:
    """Cumulative per-stage wall-clock spans
    (ref: src/project.cpp:72-91 pattern)."""

    def __init__(self) -> None:
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def span(self, stage: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[stage] += dt
            self.counts[stage] += 1

    def report(self) -> str:
        lines = [f"{'stage':<24}{'total ms':>12}{'calls':>8}{'ms/call':>12}"]
        for k in sorted(self.totals, key=self.totals.get, reverse=True):
            t = self.totals[k] * 1e3
            n = self.counts[k]
            lines.append(f"{k:<24}{t:>12.2f}{n:>8}{t / n:>12.3f}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace_to(log_dir: str) -> Iterator[None]:
    """Capture a jax.profiler device trace (view with TensorBoard)."""
    import jax
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def profile_stages(mode: int = 0, n_blocks: int = 20,
                   with_rds: bool = True) -> dict[str, float]:
    """Per-arm wall-clock attribution by configuration deltas.

    XLA fuses the whole block DAG, so individual stages cannot be timed
    in-program from the host (the reference's chrono spans,
    src/project.cpp:193-290, have no direct analog).  Instead the receiver
    runs in nested configurations — front-end+mono, +stereo, +RDS — and
    the deltas attribute time to each arm.  Returns per-block milliseconds
    per configuration plus derived arm costs.
    """
    import time

    import jax
    import jax.numpy as jnp

    from sdr_fm.models import receiver as rx
    from sdr_fm.utils import synth

    mc = cfg.get_mode_config(mode)
    with_rds = with_rds and mc.rds is not None
    bs = mc.default_block_size(with_rds)
    res = synth.synthesize_fm(duration_s=0.1, mode=mode, with_rds=with_rds,
                              seed=0)
    iq = synth.u8_to_float(res.iq_u8)[:bs]
    blk = jnp.asarray(iq, jnp.float32)
    coeffs = rx.design_coeffs(mc)

    def run(stereo, rds):
        fn = rx.make_block_fn(mc, stereo=stereo, with_rds=rds)
        st = rx.init_state(mc)
        out, st = fn(blk, coeffs, st)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(n_blocks):
            out, st = fn(blk, coeffs, st)
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / n_blocks * 1e3

    mono = run(False, False)
    stereo = run(True, False)
    result = {"mono_ms": mono, "stereo_ms": stereo,
              "stereo_arm_ms": stereo - mono,
              "realtime_budget_ms": bs / 2 / mc.rf_fs * 1e3}
    if with_rds:
        full = run(True, True)
        result["stereo_rds_ms"] = full
        result["rds_arm_ms"] = full - stereo
    return result


def mac_per_audio_sample(mc: cfg.ModeConfig, stereo: bool = False,
                         taps: int = 101) -> float:
    """MAC per output audio sample (report Table 1 model).

    Front-end: I+Q decimating FIRs produce one IF sample each per
    ``audio_decim/audio_upsamp`` audio samples at ``taps`` MACs apiece;
    mono resampler contributes ``taps`` MACs per audio sample (polyphase:
    ceil(taps*U / U) == taps); the stereo arm adds pilot+stereo band-pass
    at IF rate plus its own resampler.
    """
    if_per_audio = mc.audio_decim / mc.audio_upsamp
    front_end = 2 * taps * if_per_audio
    mono = front_end + taps
    if not stereo:
        return mono
    # Table 1's stereo increment is exactly the pilot+stereo band-pass pair
    # at IF rate (2121-1111 = 2*101*5 for mode 0); the reference does not
    # count the stereo arm's own audio FIR there — reproduced as-is so our
    # numbers are comparable to theirs.
    stereo_arm = 2 * taps * if_per_audio
    return mono + stereo_arm


def macs_per_second(mc: cfg.ModeConfig, stereo: bool = False,
                    taps: int = 101) -> float:
    """Aggregate MAC/s at the mode's audio rate — roofline numerator."""
    return mac_per_audio_sample(mc, stereo, taps) * mc.audio_fs
