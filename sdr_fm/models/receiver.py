"""FM receiver as one jitted program per block, scan over blocks.

Architecture (SURVEY.md §7): the reference's producer/consumer thread pipeline
(src/project.cpp:384-500) does not map to an accelerator — here the entire
per-block DAG

    RF front-end -> mono ∥ stereo ∥ RDS-DSP

is a single pure function ``process_block`` over an explicit state pytree,
compiled once by XLA.  Streaming over a recording is ``lax.scan`` over the
block axis (``run_blocks_scan``), so the whole receive is ONE device program
with zero host round-trips; real-time operation feeds blocks through the same
jitted step.  Every op supports leading batch dims, so a batch of independent
FM channels (data-parallel axis, SURVEY.md §2.3) runs through the same code.

Signal-flow parity targets (reference call stacks, SURVEY.md §3):
 * front-end  — src/project.cpp:40-152, model/stereo.py:164-190
 * mono path  — src/project.cpp:311-382, model/stereo.py:196-212
 * stereo     — src/project.cpp:154-309, model/stereo.py:199-246
 * RDS DSP    — model/fmRDS.py:222-254 (everything at IF rate and above);
   the symbol-rate decode (CDR/Manchester/framesync, 2375 S/s) stays on host
   by design — see sdr_fm.golden.rds and sdr_fm.models.rds_decode.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from sdr_fm import config as cfg
from sdr_fm.golden import filters as gfilt
from sdr_fm.ops import demod as jdemod
from sdr_fm.ops import fir as jfir
from sdr_fm.ops import pll as jpll


class ReceiverCoeffs(NamedTuple):
    """All FIR coefficient sets of one mode as device arrays (a pytree).

    Designed on host in float64 (coefficient design is O(taps), run once),
    stored float32 (ref design functions: model/stereo.py:90-105,
    model/fmRDS.py:112-130).
    """

    rf: jnp.ndarray
    audio: jnp.ndarray
    pilot: jnp.ndarray
    stereo: jnp.ndarray
    rds_channel: jnp.ndarray
    rds_carrier: jnp.ndarray
    rds_resampler: jnp.ndarray
    rds_rrc: jnp.ndarray


class ReceiverState(NamedTuple):
    """Inter-block carry — the checkpointable state machine
    (ref STATES struct src/project.cpp:29-36,446-468; SURVEY.md §5
    checkpoint/resume).  Every leaf may carry leading batch dims.

    Aliasing note: ``stereo_bpf``/``pilot_bpf``/``rds_channel`` are all
    overlap-save tails of the SAME ``fm`` signal, so the fused three-band
    conv path (process_block) reads only ``stereo_bpf`` and writes the
    one shared tail into all three — valid because they are identical by
    construction on every path that maintains them.  The unfused path
    honors the per-arm states individually."""

    rf_i: jnp.ndarray
    rf_q: jnp.ndarray
    demod_iq: jnp.ndarray
    mono_allpass: jnp.ndarray
    mono_fir: jnp.ndarray
    stereo_bpf: jnp.ndarray
    pilot_bpf: jnp.ndarray
    stereo_fir: jnp.ndarray
    pilot_pll: jpll.PllState
    rds_channel: jnp.ndarray
    rds_allpass: jnp.ndarray
    rds_carrier: jnp.ndarray
    rds_pll: jpll.PllState
    rds_resampler: jnp.ndarray
    rds_rrc: jnp.ndarray
    rds_resampler_q: jnp.ndarray
    rds_rrc_q: jnp.ndarray


class BlockOutputs(NamedTuple):
    """Per-block device outputs.  Disabled arms are zero-length arrays so the
    pytree structure is static for scan/jit regardless of flags."""

    fm_demod: jnp.ndarray
    mono: jnp.ndarray
    left: jnp.ndarray
    right: jnp.ndarray
    rds_symbols: jnp.ndarray    # RRC output (soft symbols at SPS*2375)
    rds_symbols_q: jnp.ndarray  # quadrature debug arm (model/fmRDS.py:251-254)


def design_coeffs(mc: cfg.ModeConfig, dtype=jnp.float32) -> ReceiverCoeffs:
    """Design every filter for one mode (host, float64 -> device float32)."""
    r = mc.rds
    f = lambda a: jnp.asarray(a, dtype=dtype)
    z = jnp.zeros((0,), dtype)
    return ReceiverCoeffs(
        rf=f(gfilt.lowpass_taps(mc.rf_taps, mc.rf_fs, cfg.RF_FC_HZ)),
        audio=f(gfilt.lowpass_taps(mc.audio_taps, mc.audio_lpf_fs,
                                   cfg.AUDIO_FC_HZ)),
        pilot=f(gfilt.bandpass_taps(mc.stereo_taps, mc.if_fs,
                                    *cfg.PILOT_BPF_HZ)),
        stereo=f(gfilt.bandpass_taps(mc.stereo_taps, mc.if_fs,
                                     *cfg.STEREO_BPF_HZ)),
        rds_channel=(f(gfilt.bandpass_taps(mc.rds_taps, mc.if_fs,
                                           *cfg.RDS_CHANNEL_BPF_HZ))
                     if r else z),
        rds_carrier=(f(gfilt.bandpass_taps(mc.rds_taps, mc.if_fs,
                                           *cfg.RDS_CARRIER_BPF_HZ))
                     if r else z),
        rds_resampler=(f(gfilt.lowpass_taps(r.resampler_taps,
                                            mc.if_fs * r.upsamp,
                                            cfg.RDS_RESAMPLER_FC_HZ))
                       if r else z),
        rds_rrc=f(gfilt.rrc_taps(r.symbol_fs, r.rrc_taps)) if r else z,
    )


def init_state(mc: cfg.ModeConfig, batch_shape: tuple[int, ...] = (),
               dtype=jnp.float32) -> ReceiverState:
    """Zero state (ref inits src/project.cpp:446-468, model/fmRDS.py:160-180).

    ``batch_shape`` prepends channel-parallel batch dims to every leaf.
    """
    r = mc.rds
    z = lambda *s: jnp.zeros(batch_shape + tuple(s), dtype)

    def pll0(nco_q_last: float = 0.0):
        st = jpll.pll_init(nco_q_last=nco_q_last, dtype=dtype)
        if batch_shape:
            st = jax.tree.map(
                lambda l: jnp.broadcast_to(l, batch_shape + l.shape), st)
        return st

    audio_state = (gfilt.resample_state_len(mc.audio_taps, mc.audio_upsamp)
                   if mc.audio_upsamp > 1 else mc.audio_taps - 1)
    return ReceiverState(
        rf_i=z(mc.rf_taps - 1),
        rf_q=z(mc.rf_taps - 1),
        demod_iq=z(2),
        mono_allpass=z((mc.stereo_taps - 1) // 2),
        mono_fir=z(audio_state),
        stereo_bpf=z(mc.stereo_taps - 1),
        pilot_bpf=z(mc.stereo_taps - 1),
        stereo_fir=z(audio_state),
        pilot_pll=pll0(),
        rds_channel=z(mc.rds_taps - 1) if r else z(0),
        rds_allpass=z((mc.rds_taps - 1) // 2) if r else z(0),
        rds_carrier=z(mc.rds_taps - 1) if r else z(0),
        # reference RDS PLL state is [0,0,1,0,1,0,1]: nco_q[0] carries 1.0
        # (model/fmRDS.py:173), unlike the stereo PLL's 0.0
        rds_pll=pll0(nco_q_last=1.0),
        rds_resampler=(z(gfilt.resample_state_len(r.resampler_taps, r.upsamp))
                       if r else z(0)),
        rds_rrc=z(r.rrc_taps - 1) if r else z(0),
        rds_resampler_q=(z(gfilt.resample_state_len(r.resampler_taps,
                                                    r.upsamp))
                         if r else z(0)),
        rds_rrc_q=z(r.rrc_taps - 1) if r else z(0),
    )


def validate_u8_rf_state(rf_i, rf_q) -> None:
    """Host-side guard for the u8 state-dtype contract.

    The u8 + ``mxu_fir`` front-end carries the RF tail in bfloat16
    (ops.fir.fir_block_decim_mm_bf16x), which is lossless ONLY when every
    tail value is k/128 for integer k in [-128, 128) — i.e. the state
    came from the u8 path or the zero init.
    Raises ValueError when a float-produced tail would be silently
    quantized.  Call with concrete (host) arrays — e.g. at checkpoint
    load (sdr_fm.checkpoint.load) or before injecting an externally
    produced state into a raw-u8 run.
    """
    for name, tail in (("rf_i", rf_i), ("rf_q", rf_q)):
        t = np.asarray(tail, np.float64) * 128.0
        # k in [-128, 127]: +128 (state exactly +1.0) is NOT byte-
        # representable — round(1.0*128)+128 = 256 would overflow u8
        if not (np.all(t == np.round(t)) and np.all(t >= -128)
                and np.all(t <= 127)):
            bad = float(np.max(np.abs(t - np.round(t))))
            raise ValueError(
                f"RF tail state '{name}' is not 1/128-quantized (max "
                f"fractional residue {bad:.3g}/128): it was produced from "
                "float input, so resuming with raw-u8 input would "
                "silently quantize it (process_block state-dtype "
                "contract).  Feed float input, or re-create the state "
                "from the u8 path.")


def pilot_pll_params(mc: cfg.ModeConfig) -> jpll.PllParams:
    """Stereo pilot PLL: 19 kHz, x2 NCO, BW 0.01 (src/project.cpp:237)."""
    return jpll.PllParams(freq=cfg.PILOT_FREQ_HZ, fs=mc.if_fs, nco_scale=2.0,
                          phase_adjust=0.0, norm_bandwidth=0.01)


def rds_pll_params(mc: cfg.ModeConfig) -> jpll.PllParams:
    """RDS carrier PLL: 114 kHz, x0.5 NCO, +3pi/8, BW 0.002
    (model/fmRDS.py:236-237)."""
    return jpll.PllParams(freq=cfg.RDS_CARRIER_FREQ_HZ, fs=mc.if_fs,
                          nco_scale=0.5, phase_adjust=3.0 * np.pi / 8.0,
                          norm_bandwidth=0.002)


def _audio_fir(x, h, state, mc: cfg.ModeConfig, mxu: bool = False):
    if mc.audio_upsamp > 1:
        fn = (jfir.fir_block_resample_mm if mxu
              else jfir.fir_block_resample)
        return fn(x, h, state, mc.audio_decim, mc.audio_upsamp)
    fn = jfir.fir_block_decim_mm if mxu else jfir.fir_block_decim
    return fn(x, h, state, mc.audio_decim)


def select_kernels() -> dict:
    """The ONE kernel choice of every production path.

    ``run_blocks_scan`` (and through it ``Receiver``),
    ``make_block_fn``, the channel- and time-sharding paths, the
    channelizer and bench.py pass exactly these static flags to
    ``process_block``, so sharded and contiguous runs compile the
    identical kernels: the precondition for the time-sharding bit-match
    invariant on the linear arms (parallel/time_shard.py).

    * ``pll_kernel``: the PLL recurrence as one GPU kernel
      (ops.pll_kernel) instead of a ``lax.scan`` of launches.
    * ``mxu_fir``: every FIR as a banded matmul (ops.fir.*_mm) instead
      of a one-feature convolution.

    Off the GPU both are off: the kernel has no CPU compilation, and on
    the CPU the banded matmul's extra FLOPs lose to the direct conv.
    """
    # both measured faster in the whole mode-0 stereo+RDS block on the
    # H100 at 1 and at 512 channels (PERF.md), so no shape threshold
    gpu = jax.default_backend() == "gpu"
    return {"mxu_fir": gpu, "pll_kernel": gpu}


def process_block(iq: jnp.ndarray, coeffs: ReceiverCoeffs,
                  state: ReceiverState, mc: cfg.ModeConfig,
                  stereo: bool = True, with_rds: bool = False,
                  rds_debug_q: bool = False,
                  pll_kernel: bool = False,
                  mxu_fir: bool = False
                  ) -> tuple[BlockOutputs, ReceiverState]:
    """One block of the full receiver DAG (pure; jit via make_block_fn).

    ``iq`` is interleaved I,Q,... of shape (..., 2*N_rf): either normalized
    float32, or RAW uint8 straight off the SDR — u8 input is normalized
    on-device ((x-128)/128, src/iofunc.cpp:133-134), which quarters the
    HBM traffic of the input stream (the bandwidth bottleneck in the
    channel-batched serving regime).  Leading dims are an
    independent-channel batch.  ``mc``/``stereo``/``with_rds``/ the kernel
    selectors must be static under jit (defaults: ``select_kernels``).
    ``mxu_fir`` runs EVERY FIR stage as a banded matmul (ops.fir.*_mm);
    ``pll_kernel`` runs the PLL recurrence as the GPU kernel
    (ops.pll_kernel).

    State-dtype contract: on the u8 + ``mxu_fir`` paths the RF overlap-
    save state is assumed u8-normalized (its f32 values are k/128 for
    integer k in [-128, 128)), which is bf16-exact and losslessly
    recoverable as bytes.  That holds whenever the state was produced by
    this same path (or is the zero init); resuming a checkpoint that was
    produced from FLOAT input with raw-u8 input afterwards would silently
    quantize the carried RF tail to the nearest 1/128 for one block
   .  Mixing input dtypes across a checkpoint is unsupported.
    """
    # u8 + matmul front-end: normalize into EXACT bfloat16 — (x-128)/128 is an
    # 8-bit integer times 2^-7, exactly representable in bf16, so the
    # normalized bf16 values are bit-identical to the f32 ones while the
    # normalize pass + window gather move half the bytes and the RF matmul
    # runs on native bf16 operands (ops.fir.fir_block_decim_mm_bf16x).
    u8_bf16_fe = iq.dtype == jnp.uint8 and mxu_fir
    if iq.dtype == jnp.uint8 and not u8_bf16_fe:
        iq = (iq.astype(jnp.float32) - 128.0) * jnp.float32(1.0 / 128.0)
    s = state
    upd: dict = {}
    empty = jnp.zeros(iq.shape[:-1] + (0,), jnp.float32)
    fb_multi = jfir.fir_block_multi_mm if mxu_fir else jfir.fir_block_multi
    fb_resamp = (jfir.fir_block_resample_mm if mxu_fir
                 else jfir.fir_block_resample)
    fb_unit = ((lambda x, h, st: jfir.fir_block_decim_mm(x, h, st, 1))
               if mxu_fir else jfir.fir_block)

    # --- RF front-end (ref src/project.cpp:40-152) -----------------------
    if mxu_fir:
        # one matmul over the stacked I/Q pair (doubles M, same W);
        # deinterleave via reshape+transpose (the elementwise normalize
        # fuses into the transpose copy)
        iq2 = jnp.moveaxis(
            iq.reshape(iq.shape[:-1] + (iq.shape[-1] // 2, 2)), -1, -2)
        st2 = jnp.stack([s.rf_i, s.rf_q], axis=-2)
        if u8_bf16_fe:
            # deinterleave + normalize fuse into one u8->bf16 pass; the
            # f32 state tail is bf16-exact (it was produced by this same
            # path last block, or is the zero init), so the round-trip
            # through the f32 state pytree is lossless
            iq2 = ((iq2.astype(jnp.bfloat16) - jnp.bfloat16(128.0))
                   * jnp.bfloat16(1.0 / 128.0))
            ds2, nst2 = jfir.fir_block_decim_mm_bf16x(
                iq2, coeffs.rf, st2.astype(jnp.bfloat16), mc.rf_decim)
            nst2 = nst2.astype(jnp.float32)
        else:
            ds2, nst2 = jfir.fir_block_decim_mm(iq2, coeffs.rf, st2,
                                                mc.rf_decim)
        i_ds, q_ds = ds2[..., 0, :], ds2[..., 1, :]
        upd["rf_i"], upd["rf_q"] = nst2[..., 0, :], nst2[..., 1, :]
    else:
        i_ds, upd["rf_i"] = jfir.fir_block_decim(iq[..., 0::2], coeffs.rf,
                                                 s.rf_i, mc.rf_decim)
        q_ds, upd["rf_q"] = jfir.fir_block_decim(iq[..., 1::2], coeffs.rf,
                                                 s.rf_q, mc.rf_decim)
    fm, upd["demod_iq"] = jdemod.fm_demod_quad(i_ds, q_ds, s.demod_iq)

    # --- Mono, delay-matched to the band-pass arms (src/project.cpp:198) --
    fm_delayed, upd["mono_allpass"] = jfir.allpass_delay(fm, s.mono_allpass)
    if not stereo:
        mono, upd["mono_fir"] = _audio_fir(fm_delayed, coeffs.audio,
                                           s.mono_fir, mc, mxu_fir)

    # --- Band-pass arms (stereo src/project.cpp:154-309; RDS
    # model/fmRDS.py:222-254).
    rds_on = with_rds and mc.rds is not None
    if stereo and rds_on and mc.rds_taps == mc.stereo_taps:
        # the three band-passes share input AND length: one conv with the
        # taps on the feature dimension instead of three C=1 convs;
        # their overlap-save states are all the same fm tail
        hs = jnp.stack([coeffs.stereo, coeffs.pilot, coeffs.rds_channel])
        filt3, tail = fb_multi(fm, hs, s.stereo_bpf)
        st_filt, pi_filt, chan = (filt3[..., 0, :], filt3[..., 1, :],
                                  filt3[..., 2, :])
        upd["stereo_bpf"] = upd["pilot_bpf"] = upd["rds_channel"] = tail
    else:
        if stereo:
            hs = jnp.stack([coeffs.stereo, coeffs.pilot])
            filt2, tail = fb_multi(fm, hs, s.stereo_bpf)
            st_filt, pi_filt = filt2[..., 0, :], filt2[..., 1, :]
            upd["stereo_bpf"] = upd["pilot_bpf"] = tail
        if rds_on:
            chan, upd["rds_channel"] = fb_unit(fm, coeffs.rds_channel,
                                               s.rds_channel)
    if rds_on:
        r = mc.rds
        chan_delayed, upd["rds_allpass"] = jfir.allpass_delay(chan,
                                                              s.rds_allpass)
        carrier, upd["rds_carrier"] = fb_unit(chan * chan,
                                              coeffs.rds_carrier,
                                              s.rds_carrier)

    # --- Carrier recovery: the receiver's only sequential recurrences.
    # When BOTH arms are on, the pilot and RDS-carrier PLLs run as ONE
    # fused recurrence (ops.pll.pll_block_fused): bit-identical outputs,
    # half the serial loop length per block.
    if stereo and rds_on:
        pll_in = jnp.stack([pi_filt, carrier], axis=-2)   # (..., 2, N)
        pll_st = jax.tree.map(lambda a, b: jnp.stack([a, b], axis=-1),
                              s.pilot_pll, s.rds_pll)
        ncos, ncos_q, pll_out = jpll.pll_block_fused(
            pll_in, pll_st, (pilot_pll_params(mc), rds_pll_params(mc)),
            kernel=pll_kernel)
        nco, nco_r = ncos[..., 0, :], ncos[..., 1, :]
        nco_rq = ncos_q[..., 1, :]
        upd["pilot_pll"] = jax.tree.map(lambda l: l[..., 0], pll_out)
        upd["rds_pll"] = jax.tree.map(lambda l: l[..., 1], pll_out)
    else:
        if stereo:
            nco, _, upd["pilot_pll"] = jpll.pll_block(
                pi_filt, s.pilot_pll, pilot_pll_params(mc), kernel=pll_kernel)
        if rds_on:
            nco_r, nco_rq, upd["rds_pll"] = jpll.pll_block(
                carrier, s.rds_pll, rds_pll_params(mc), kernel=pll_kernel)
    if stereo:
        mixer = nco[..., :-1] * st_filt * 2.0
    if rds_on:
        rds_mixer = nco_r[..., :-1] * chan_delayed * 2.0

    if stereo:
        # mono + stereo share the audio LPF/resampler: one batched call
        # (stacked on a new leading axis) instead of two
        pair = jnp.stack([fm_delayed, mixer], axis=-2)
        st_pair = jnp.stack([s.mono_fir, s.stereo_fir], axis=-2)
        out2, nst2 = _audio_fir(pair, coeffs.audio, st_pair, mc, mxu_fir)
        mono, st_final = out2[..., 0, :], out2[..., 1, :]
        upd["mono_fir"] = nst2[..., 0, :]
        upd["stereo_fir"] = nst2[..., 1, :]
        left = mono + st_final
        right = mono - st_final
    else:
        left = right = empty

    if rds_on:
        resampled, upd["rds_resampler"] = fb_resamp(
            rds_mixer, coeffs.rds_resampler, s.rds_resampler,
            r.decim, r.upsamp)
        symbols, upd["rds_rrc"] = fb_unit(resampled, coeffs.rds_rrc,
                                          s.rds_rrc)
        symbols_q = empty
        if rds_debug_q:
            # quadrature debug arm for constellation inspection
            # (model/fmRDS.py:251-254): same chain mixed with the Q NCO
            mixer_q = nco_rq[..., :-1] * chan_delayed * 2.0
            res_q, upd["rds_resampler_q"] = fb_resamp(
                mixer_q, coeffs.rds_resampler, s.rds_resampler_q,
                r.decim, r.upsamp)
            symbols_q, upd["rds_rrc_q"] = fb_unit(
                res_q, coeffs.rds_rrc, s.rds_rrc_q)
    else:
        symbols = symbols_q = empty

    new_state = s._replace(**upd)
    out = BlockOutputs(fm_demod=fm, mono=mono, left=left, right=right,
                       rds_symbols=symbols, rds_symbols_q=symbols_q)
    return out, new_state


def process_block_channel_chunked(iq: jnp.ndarray, coeffs: ReceiverCoeffs,
                                  state: ReceiverState, mc: cfg.ModeConfig,
                                  stereo: bool = True,
                                  with_rds: bool = False,
                                  channel_chunk: int = 512,
                                  **kernel_kw
                                  ) -> tuple[BlockOutputs, ReceiverState]:
    """``process_block`` over a large channel batch as SEQUENTIAL
    sub-batches of ``channel_chunk`` channels (``lax.map``).

    Bounds the working set of one program: a C=1024 batch runs as two
    512-channel programs back to back, one compiled body reused per
    chunk.  Per-channel outputs equal the
    direct call up to batch-size-dependent matmul accumulation roundoff
    (XLA may vectorize the contraction differently at different batch
    sizes; the raw-byte state tails are bit-identical), so locked-PLL
    outputs agree to ~1e-4 and the streaming contract is unchanged.
    Falls through to ``process_block`` when the batch is not a whole
    number (>1) of chunks.  The leading batch dim must be 1-D (C,).
    """
    lead = iq.shape[:-1]
    if len(lead) != 1 or lead[0] <= channel_chunk \
            or lead[0] % channel_chunk:
        return process_block(iq, coeffs, state, mc, stereo=stereo,
                             with_rds=with_rds, **kernel_kw)
    c = lead[0]
    k = c // channel_chunk
    split = lambda a: a.reshape((k, channel_chunk) + a.shape[1:])
    join = lambda a: a.reshape((c,) + a.shape[2:])

    def body(args):
        iq_k, st_k = args
        return process_block(iq_k, coeffs, st_k, mc, stereo=stereo,
                             with_rds=with_rds, **kernel_kw)

    if k <= 4:
        # unroll small chunk counts: a static loop slices at compile time
        # instead of lax.map's per-iteration dynamic slice/stack of the
        # big operands
        per = [body((iq[i * channel_chunk:(i + 1) * channel_chunk],
                     jax.tree.map(
                         lambda a: a[i * channel_chunk:
                                     (i + 1) * channel_chunk], state)))
               for i in range(k)]
        outs = jax.tree.map(lambda *xs: jnp.concatenate(xs), *[o for o, _ in per])
        new_state = jax.tree.map(lambda *xs: jnp.concatenate(xs),
                                 *[s for _, s in per])
        return outs, new_state

    outs, new_state = lax.map(
        body, (split(iq), jax.tree.map(split, state)))
    return jax.tree.map(join, outs), jax.tree.map(join, new_state)


# ModeConfig is a frozen (hashable) dataclass: it IS the static jit key, so
# custom configs (cfg.custom_mode) compile distinct programs correctly.
# The state pytree is DONATED: every caller chains it (out state replaces
# in state), so XLA reuses its buffers in place — no per-step allocation
# or copy for the carry in the streaming regime.
@functools.partial(jax.jit, static_argnames=("mc", "stereo", "with_rds",
                                             "rds_debug_q", "pll_kernel",
                                             "mxu_fir"),
                   donate_argnames=("state",))
def _block_step(iq, coeffs, state, mc, stereo, with_rds, rds_debug_q=False,
                pll_kernel=False, mxu_fir=False):
    return process_block(iq, coeffs, state, mc, stereo=stereo,
                         with_rds=with_rds, rds_debug_q=rds_debug_q,
                         pll_kernel=pll_kernel, mxu_fir=mxu_fir)


def make_block_fn(mc: cfg.ModeConfig, stereo: bool = True,
                  with_rds: bool = False, rds_debug_q: bool = False,
                  **kernels):
    """Jitted (iq, coeffs, state) -> (BlockOutputs, state) for one mode.

    Kernel selectors (``pll_kernel``, ``mxu_fir``) not given here are
    taken from ``select_kernels``.
    """
    def fn(iq, coeffs, state):
        sel = {**select_kernels(), **kernels}
        return _block_step(iq, coeffs, state, mc, stereo, with_rds,
                           rds_debug_q, **sel)
    return fn


@functools.partial(jax.jit, static_argnames=("mode", "stereo", "with_rds"))
def run_blocks_scan(iq_blocks: jnp.ndarray, coeffs: ReceiverCoeffs,
                    state: ReceiverState, mode, stereo: bool = True,
                    with_rds: bool = False
                    ) -> tuple[BlockOutputs, ReceiverState]:
    """Whole-recording streaming as ONE device program.

    ``iq_blocks`` has shape (n_blocks, ..., block_len): scan axis first, then
    optional channel-batch dims.  Replaces the reference's while-loop over
    blocks (model/stereo.py:152) with ``lax.scan``; outputs come back stacked
    (n_blocks, ..., out_len).  ``mode`` is an int mode id or a (custom)
    ModeConfig.
    """
    mc = (mode if isinstance(mode, cfg.ModeConfig)
          else cfg.get_mode_config(mode))
    sel = select_kernels()

    def step(st, iq):
        out, st = process_block(iq, coeffs, st, mc, stereo=stereo,
                                with_rds=with_rds, **sel)
        return st, out

    final_state, outs = lax.scan(step, state, iq_blocks)
    return outs, final_state


class Receiver:
    """Convenience stateful wrapper around the pure functions.

    Owns coeffs + running state; ``process(iq)`` consumes one block,
    ``run(iq)`` consumes a whole recording via scan.  The state pytree is
    exposed for checkpoint/resume (SURVEY.md §5: block-k restart from saved
    state is bit-identical).
    """

    def __init__(self, mode: int | cfg.Mode | cfg.ModeConfig = 0,
                 stereo: bool = True, with_rds: bool = False,
                 batch_shape: tuple[int, ...] = ()):
        self.mc = (mode if isinstance(mode, cfg.ModeConfig)
                   else cfg.get_mode_config(mode))
        self.stereo = stereo
        self.with_rds = with_rds and self.mc.rds is not None
        self.coeffs = design_coeffs(self.mc)
        self.state = init_state(self.mc, batch_shape)
        self._fn = make_block_fn(self.mc, self.stereo, self.with_rds)

    @staticmethod
    def _as_input(x):
        """uint8 stays uint8 (normalized on-device); everything else f32.
        Device arrays pass through untouched — no host round-trip on the
        hot path (e.g. channelizer output feeding process())."""
        if isinstance(x, jnp.ndarray) and x.dtype in (jnp.uint8,
                                                      jnp.float32):
            return x
        a = np.asarray(x)
        return a if a.dtype == np.uint8 else a.astype(np.float32)

    def process(self, iq_block) -> BlockOutputs:
        iq = jnp.asarray(self._as_input(iq_block))
        out, self.state = self._fn(iq, self.coeffs, self.state)
        return out

    def run(self, iq: np.ndarray,
            block_size: Optional[int] = None) -> BlockOutputs:
        """Scan a whole recording; returns stacked per-block outputs."""
        if block_size is None:
            block_size = self.mc.default_block_size(self.with_rds)
        n_blocks = iq.shape[-1] // block_size
        blocks = np.moveaxis(
            self._as_input(iq[..., : n_blocks * block_size])
            .reshape(iq.shape[:-1] + (n_blocks, block_size)), -2, 0)
        outs, self.state = run_blocks_scan(
            jnp.asarray(blocks), self.coeffs, self.state, self.mc,
            self.stereo, self.with_rds)
        return outs

    def iter_run(self, iq: np.ndarray, block_size: Optional[int] = None,
                 chunk_blocks: int = 64):
        """Stream a long recording in chunks of ``chunk_blocks`` blocks.

        Device AND host memory stay O(chunk) however long the capture
        (BASELINE.json's pod-scale config is a 1-hour recording — ``run``'s
        stacked output would not fit).  State carries across chunk
        dispatches, so the concatenated outputs are bit-identical to one
        ``run`` over the whole recording.  Yields each chunk's stacked
        ``BlockOutputs`` as host numpy arrays (the transfer is what bounds
        device residency)."""
        if block_size is None:
            block_size = self.mc.default_block_size(self.with_rds)
        n_blocks = iq.shape[-1] // block_size
        # force the source to HOST numpy: a device-array input would keep
        # the whole capture resident on device (and round-trip each chunk),
        # breaking the O(chunk) device-memory claim
        iq = np.asarray(self._as_input(iq[..., : n_blocks * block_size]))
        for k0 in range(0, n_blocks, chunk_blocks):
            k1 = min(k0 + chunk_blocks, n_blocks)
            chunk = iq[..., k0 * block_size: k1 * block_size]
            blocks = np.moveaxis(
                np.asarray(chunk).reshape(
                    iq.shape[:-1] + (k1 - k0, block_size)), -2, 0)
            outs, self.state = run_blocks_scan(
                jnp.asarray(blocks), self.coeffs, self.state, self.mc,
                self.stereo, self.with_rds)
            yield jax.tree.map(np.asarray, outs)
