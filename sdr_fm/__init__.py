"""sdr_fm — a software-defined FM radio framework on JAX.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of the reference
FM receiver (mnigm2001/Software-Defined-Radio): raw 8-bit interleaved I/Q
samples -> mono audio, stereo audio, and RDS data.

Design stance (accelerator-first, not a port):

* Every FIR (plain / decimating / polyphase rational-resampling) is a single
  XLA ``conv_general_dilated`` — strides express decimation, LHS dilation
  expresses upsampling.  No scalar loops.
* Streaming is a ``lax.scan`` over fixed-size blocks with an explicit,
  checkpointable state pytree — not producer/consumer threads.
* The per-sample PLL recurrence is a ``lax.scan`` (and a Pallas GPU kernel
  for the optimized path); everything at or above IF rate runs on the device,
  symbol-rate RDS bit decode runs on the host (it is ~kb/s).
* Scaling is sharding: a channel batch axis over a ``jax.sharding.Mesh``
  (data-parallel) and time-sharding of long recordings with overlap-save
  halo exchange (sequence-parallel), not hand-written MPI threads.

Layer map (mirrors SURVEY.md section 1):

* ``sdr_fm.config``   — typed per-mode parameter tables (ref: src/project.cpp:424-427)
* ``sdr_fm.golden``   — numpy golden model, the correctness oracle
  (ref: model/fmSupportLib.py)
* ``sdr_fm.ops``      — JAX/XLA/Pallas DSP primitives (ref: src/filter.cpp)
* ``sdr_fm.models``   — processing paths: frontend/mono/stereo/RDS/receiver
  (ref: src/project.cpp:40-382, model/stereo.py, model/fmRDS.py)
* ``sdr_fm.parallel`` — mesh sharding: channel-parallel and time-sharding
* ``sdr_fm.io``       — raw IQ readers, PCM/WAV writers, host feed
  (ref: src/iofunc.cpp)
* ``sdr_fm.native``   — native C++ host runtime bindings: conversions and
  the threaded bounded-queue feed (ref: src/project.cpp:384-500)
* ``sdr_fm.utils``    — synthesis, metrics, logging, plotting, profiling
* ``sdr_fm.checkpoint`` — state save/resume (bit-identical restart)
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__version__ = "0.1.0"

from sdr_fm.config import (  # noqa: F401
    Mode,
    ModeConfig,
    custom_mode,
    get_mode_config,
)


@dataclasses.dataclass
class ReceiveResult:
    """One-call receive output: concatenated audio + decoded RDS."""

    audio_fs: float
    mono: "np.ndarray"
    left: Optional["np.ndarray"]
    right: Optional["np.ndarray"]
    rds_frames: list
    rds_info_words: "np.ndarray"


def receive(iq, mode: int | Mode | ModeConfig = 0, stereo: bool = True,
            rds: bool = True) -> ReceiveResult:
    """Demodulate a whole capture in one call.

    ``iq`` is a path to a raw interleaved-u8 file, a u8 array, or a
    normalized float array.  Returns concatenated audio (mono always;
    left/right when ``stereo``) and decoded RDS frames/info words.  The
    capture is consumed to the last whole block multiple (a sub-24 ms
    tail is processed as a final smaller block, not dropped).
    """
    import os

    import numpy as np

    from sdr_fm.models import rds_decode
    from sdr_fm.models import receiver as rx

    if isinstance(iq, (str, os.PathLike)):
        iq = np.fromfile(iq, dtype=np.uint8)
    iq = np.asarray(iq)
    mc = mode if isinstance(mode, ModeConfig) else get_mode_config(mode)
    with_rds = rds and mc.rds is not None
    gran = mc.if_block_multiple(with_rds) * 2 * mc.rf_decim
    usable = len(iq) // gran * gran
    if usable == 0:
        raise ValueError(
            f"capture of {len(iq)} samples is shorter than one block "
            f"multiple ({gran} interleaved u8 samples) for mode "
            f"{int(mc.mode)}{' with RDS' if with_rds else ''}")
    r = rx.Receiver(mc, stereo=stereo, with_rds=with_rds)
    bs = min(mc.default_block_size(with_rds), usable)
    outs = r.run(iq[:usable // bs * bs], block_size=bs)
    parts = [outs]
    tail = iq[usable // bs * bs: usable]
    if len(tail):
        parts.append(r.process(tail))

    flat = lambda arrs: np.concatenate(
        [np.asarray(a).reshape(-1) for a in arrs])
    frames: list = []
    words = np.zeros((0, 16), np.int64)
    if with_rds:
        dec = rds_decode.decode_robust(
            flat([p.rds_symbols for p in parts]), mc.rds.sps)
        frames = dec.frames.matches
        words = dec.info_words
    return ReceiveResult(
        audio_fs=mc.audio_fs,
        mono=flat([p.mono for p in parts]),
        left=flat([p.left for p in parts]) if stereo else None,
        right=flat([p.right for p in parts]) if stereo else None,
        rds_frames=frames,
        rds_info_words=words,
    )
