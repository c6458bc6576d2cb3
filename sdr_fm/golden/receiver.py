"""Golden end-to-end receiver paths (numpy, block-streaming).

Mirrors the reference's processing graphs:

* RF front-end: I/Q deinterleave -> 100 kHz LPF x2 -> /rf_decim -> FM demod
  (src/project.cpp:40-152, model/stereo.py:164-190).
* Mono path: allpass delay-match -> 16 kHz LPF + decimate/resample
  (src/project.cpp:311-382, model/stereo.py:196-212).
* Stereo path: pilot BPF -> PLL(x2) -> mixer with 22-54 kHz BPF arm ->
  LPF/resample -> L/R combine (src/project.cpp:154-309, model/stereo.py:199-246).
* RDS path: 54-60 kHz BPF -> delay-match + squaring -> 113.5-114.5 kHz BPF ->
  PLL(x0.5, +3pi/8, BW 0.002) -> mixer -> rational resample -> RRC -> CDR ->
  Manchester/diff decode -> frame sync (model/fmRDS.py:222-296).

This is the oracle the JAX receiver (sdr_fm.models.receiver) is tested
against block-by-block and end-to-end.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from sdr_fm import config as cfg
from sdr_fm.golden import demod, filters, pll, rds


@dataclasses.dataclass
class GoldenCoeffs:
    rf: np.ndarray
    audio: np.ndarray
    pilot: np.ndarray
    stereo: np.ndarray
    rds_channel: np.ndarray
    rds_carrier: np.ndarray
    rds_resampler: np.ndarray
    rds_rrc: np.ndarray


def design_coeffs(mc: cfg.ModeConfig) -> GoldenCoeffs:
    """All filter coefficient sets for one mode
    (model/stereo.py:90-105, model/fmRDS.py:112-130)."""
    r = mc.rds
    return GoldenCoeffs(
        rf=filters.lowpass_taps(mc.rf_taps, mc.rf_fs, cfg.RF_FC_HZ),
        audio=filters.lowpass_taps(mc.audio_taps, mc.audio_lpf_fs,
                                   cfg.AUDIO_FC_HZ),
        pilot=filters.bandpass_taps(mc.stereo_taps, mc.if_fs,
                                    *cfg.PILOT_BPF_HZ),
        stereo=filters.bandpass_taps(mc.stereo_taps, mc.if_fs,
                                     *cfg.STEREO_BPF_HZ),
        rds_channel=(filters.bandpass_taps(mc.rds_taps, mc.if_fs,
                                           *cfg.RDS_CHANNEL_BPF_HZ)
                     if r else np.zeros(0)),
        rds_carrier=(filters.bandpass_taps(mc.rds_taps, mc.if_fs,
                                           *cfg.RDS_CARRIER_BPF_HZ)
                     if r else np.zeros(0)),
        rds_resampler=(filters.lowpass_taps(r.resampler_taps,
                                            mc.if_fs * r.upsamp,
                                            cfg.RDS_RESAMPLER_FC_HZ)
                       if r else np.zeros(0)),
        rds_rrc=(filters.rrc_taps(r.symbol_fs, r.rrc_taps)
                 if r else np.zeros(0)),
    )


@dataclasses.dataclass
class GoldenState:
    """All inter-block carries — the checkpointable state machine
    (src/project.cpp:29-36,446-468; model/fmRDS.py:160-180)."""

    rf_i: np.ndarray
    rf_q: np.ndarray
    demod_iq: np.ndarray
    mono_allpass: np.ndarray
    mono_fir: np.ndarray
    stereo_bpf: np.ndarray
    pilot_bpf: np.ndarray
    stereo_fir: np.ndarray
    pilot_pll: pll.PllState
    rds_channel: np.ndarray
    rds_allpass: np.ndarray
    rds_carrier: np.ndarray
    rds_pll: pll.PllState
    rds_resampler: np.ndarray
    rds_rrc: np.ndarray
    rds_cdr: rds.CdrState
    rds_bits: np.ndarray  # undecoded bit backlog for frame sync


def init_state(mc: cfg.ModeConfig) -> GoldenState:
    r = mc.rds
    z = np.zeros
    return GoldenState(
        rf_i=z(mc.rf_taps - 1),
        rf_q=z(mc.rf_taps - 1),
        demod_iq=z(2),
        mono_allpass=z((mc.stereo_taps - 1) // 2),
        mono_fir=z(filters.resample_state_len(mc.audio_taps, mc.audio_upsamp)
                   if mc.audio_upsamp > 1 else mc.audio_taps - 1),
        stereo_bpf=z(mc.stereo_taps - 1),
        pilot_bpf=z(mc.stereo_taps - 1),
        stereo_fir=z(filters.resample_state_len(mc.audio_taps, mc.audio_upsamp)
                     if mc.audio_upsamp > 1 else mc.audio_taps - 1),
        pilot_pll=pll.PllState(nco_q_last=0.0),
        rds_channel=z(mc.rds_taps - 1) if r else z(0),
        rds_allpass=z((mc.rds_taps - 1) // 2) if r else z(0),
        rds_carrier=z(mc.rds_taps - 1) if r else z(0),
        rds_pll=pll.PllState(),
        rds_resampler=(z(filters.resample_state_len(r.resampler_taps, r.upsamp))
                       if r else z(0)),
        rds_rrc=z(r.rrc_taps - 1) if r else z(0),
        rds_cdr=rds.CdrState(),
        rds_bits=np.zeros(0, dtype=np.int64),
    )


@dataclasses.dataclass
class BlockOutputs:
    fm_demod: np.ndarray
    mono: np.ndarray
    left: Optional[np.ndarray] = None
    right: Optional[np.ndarray] = None
    rds_symbols: Optional[np.ndarray] = None   # RRC output (soft symbols)
    rds_bits: Optional[np.ndarray] = None      # post-diff-decode bits
    rds_frames: Optional[rds.FrameSyncResult] = None


def _audio_fir(x, h, state, mc: cfg.ModeConfig):
    if mc.audio_upsamp > 1:
        return filters.block_fir_resample(x, h, state, mc.audio_decim,
                                          mc.audio_upsamp)
    return filters.block_fir_decim(x, h, state, mc.audio_decim)


def process_block(iq_block: np.ndarray, coeffs: GoldenCoeffs,
                  state: GoldenState, mc: cfg.ModeConfig,
                  stereo: bool = True, with_rds: bool = False,
                  block_count: int = 0) -> tuple[BlockOutputs, GoldenState]:
    """Process one block of normalized float IQ (interleaved I,Q,I,Q,...).

    The input ``state`` is never mutated: all updates land on a shallow
    copy that is returned, so callers may snapshot states across blocks
    exactly like with the JAX layer's immutable pytree.
    """
    s = dataclasses.replace(state)
    # --- RF front-end -----------------------------------------------------
    i_raw = iq_block[0::2]
    q_raw = iq_block[1::2]
    i_ds, s.rf_i = filters.block_fir_decim(i_raw, coeffs.rf, s.rf_i,
                                           mc.rf_decim)
    q_ds, s.rf_q = filters.block_fir_decim(q_raw, coeffs.rf, s.rf_q,
                                           mc.rf_decim)
    fm, s.demod_iq = demod.fm_demod_quad(i_ds, q_ds, s.demod_iq)

    # --- Mono ------------------------------------------------------------
    # Always delay-matched to the band-pass arms.  Documented divergence:
    # the reference's mono-only build (src/threadMonoOnly.cpp) applies no
    # allpass; we keep the delay in both paths so mono/stereo/RDS share one
    # timeline (a pure 75-IF-sample shift, inaudible and phase-exact).
    fm_delayed, s.mono_allpass = filters.allpass_delay(fm, s.mono_allpass)
    mono, s.mono_fir = _audio_fir(fm_delayed, coeffs.audio, s.mono_fir, mc)

    out = BlockOutputs(fm_demod=fm, mono=mono)

    # --- Stereo -----------------------------------------------------------
    if stereo:
        st_filt, s.stereo_bpf = filters.block_fir(fm, coeffs.stereo,
                                                  s.stereo_bpf)
        pi_filt, s.pilot_bpf = filters.block_fir(fm, coeffs.pilot,
                                                 s.pilot_bpf)
        nco, _, s.pilot_pll = pll.fm_pll(pi_filt, cfg.PILOT_FREQ_HZ, mc.if_fs,
                                         s.pilot_pll, nco_scale=2.0)
        mixer = nco[:-1] * st_filt * 2.0
        st_final, s.stereo_fir = _audio_fir(mixer, coeffs.audio,
                                            s.stereo_fir, mc)
        out.left = mono + st_final
        out.right = mono - st_final

    # --- RDS --------------------------------------------------------------
    if with_rds and mc.rds is not None:
        r = mc.rds
        chan, s.rds_channel = filters.block_fir(fm, coeffs.rds_channel,
                                                s.rds_channel)
        chan_delayed, s.rds_allpass = filters.allpass_delay(chan,
                                                            s.rds_allpass)
        squared = chan * chan
        carrier, s.rds_carrier = filters.block_fir(squared, coeffs.rds_carrier,
                                                   s.rds_carrier)
        nco, nco_q, s.rds_pll = pll.fm_pll(
            carrier, cfg.RDS_CARRIER_FREQ_HZ, mc.if_fs, s.rds_pll,
            nco_scale=0.5, phase_adjust=3.0 * np.pi / 8.0,
            norm_bandwidth=0.002)
        mixer = nco[:-1] * chan_delayed * 2.0
        resampled, s.rds_resampler = filters.block_fir_resample(
            mixer, coeffs.rds_resampler, s.rds_resampler, r.decim, r.upsamp)
        symbols, s.rds_rrc = filters.block_fir(resampled, coeffs.rds_rrc,
                                               s.rds_rrc)
        out.rds_symbols = symbols

        manch_bits, s.rds_cdr = rds.cdr(symbols, r.sps, s.rds_cdr,
                                        block_count)
        bits = rds.diff_decode(manch_bits)
        stream = np.concatenate([s.rds_bits, bits])
        frames = rds.frame_sync(stream)
        s.rds_bits = stream[frames.consumed:]
        out.rds_bits = bits
        out.rds_frames = frames

    return out, s


def run_file(iq_float: np.ndarray, mc: cfg.ModeConfig, stereo: bool = True,
             with_rds: bool = False,
             block_size: Optional[int] = None) -> list[BlockOutputs]:
    """Block-loop driver over a whole recording
    (model/stereo.py:152, model/fmRDS.py:198)."""
    if block_size is None:
        block_size = mc.default_block_size(with_rds)
    coeffs = design_coeffs(mc)
    state = init_state(mc)
    outs = []
    n_blocks = len(iq_float) // block_size
    for b in range(n_blocks):
        blk = iq_float[b * block_size:(b + 1) * block_size]
        out, state = process_block(blk, coeffs, state, mc, stereo=stereo,
                                   with_rds=with_rds, block_count=b)
        outs.append(out)
    return outs
