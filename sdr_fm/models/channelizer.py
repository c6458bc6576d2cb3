"""Wideband channelizer: one capture -> a batch of station basebands.

The reference receives one station whose IQ is already centered
(rtl_sdr tunes the dongle).  On an accelerator the natural serving shape
is many stations at once (the channel-parallel axis, SURVEY.md §2.3): this stage
takes a single wideband capture at ``fs_wide`` and produces the (C, 2*N)
interleaved channel batch the receiver consumes —

    z_k[n] = sum FIR( x[n] * exp(-j 2 pi f_k n / fs_wide) ) down to rf_fs

All C channels mix/filter/decimate in one batched program: the mixer is a
broadcast complex multiply, the anti-alias FIR+decimate reuses the
receiver's FIR kernels with the (C, 2 [I/Q]) leading batch dims, and the
per-channel oscillator phase carries across blocks so streaming is
continuous.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from sdr_fm import config as cfg
from sdr_fm.golden import filters as gfilt
from sdr_fm.models.receiver import select_kernels
from sdr_fm.ops import fir as jfir


class ChannelizerState(NamedTuple):
    fir: jnp.ndarray     # (C, 2, taps-1) anti-alias FIR tails
    phi0: jnp.ndarray    # (C,) carried mixer phase (wrapped)


class Channelizer:
    """Streaming wideband -> channel-batch front end.

    ``offsets_hz`` are station carrier offsets relative to the capture
    center; ``fs_wide`` must be an integer multiple of ``mc.rf_fs``.
    ``process(block)`` takes interleaved wideband IQ (u8 or float,
    length 2*N_wide with N_wide divisible by the decimation) and returns
    (C, 2*N_wide/decim) interleaved float32 ready for a batched Receiver.
    """

    def __init__(self, offsets_hz: Sequence[float], fs_wide: float,
                 mode: int | cfg.Mode | cfg.ModeConfig = 0,
                 taps: int = 151):
        self.mc = (mode if isinstance(mode, cfg.ModeConfig)
                   else cfg.get_mode_config(mode))
        self.fs_wide = float(fs_wide)
        self.decim = int(round(fs_wide / self.mc.rf_fs))
        if abs(fs_wide - self.decim * self.mc.rf_fs) > 1e-6:
            raise ValueError(f"fs_wide {fs_wide} must be an integer "
                             f"multiple of rf_fs {self.mc.rf_fs}")
        self.offsets = tuple(float(f) for f in offsets_hz)
        c = len(offsets_hz)
        # anti-alias below the post-decimation Nyquist rf_fs/2
        self.coeffs = jnp.asarray(
            gfilt.lowpass_taps(taps, fs_wide, 0.45 * self.mc.rf_fs),
            jnp.float32)
        self.state = ChannelizerState(
            fir=jnp.zeros((c, 2, taps - 1), jnp.float32),
            phi0=jnp.zeros((c,), jnp.float32))

    def process(self, iq_wide) -> jnp.ndarray:
        arr = np.asarray(iq_wide)
        blk = jnp.asarray(arr if arr.dtype == np.uint8
                          else arr.astype(np.float32))
        out, self.state = _channelize_block(
            blk, self.coeffs, self.state, self.offsets, self.fs_wide,
            self.decim)
        return out


@functools.partial(jax.jit,
                   static_argnames=("offsets", "fs_wide", "decim"))
def _channelize_block(iq: jnp.ndarray, h: jnp.ndarray,
                      state: ChannelizerState, offsets: tuple,
                      fs_wide: float, decim: int
                      ) -> tuple[jnp.ndarray, ChannelizerState]:
    if iq.dtype == jnp.uint8:
        iq = (iq.astype(jnp.float32) - 128.0) * jnp.float32(1.0 / 128.0)
    i_w = iq[0::2]
    q_w = iq[1::2]
    n = i_w.shape[-1]
    assert n % decim == 0, (n, decim)

    # Mixer phases w_k*n must stay accurate over long blocks, beyond what
    # float32 w*arange(n) gives (ulp ~0.1 rad at n ~ 1e6).  Offsets are
    # static, so decompose n = a*K + b with host-side float64 residues:
    # ph = (w*K mod 2pi)*a + (w mod 2pi)*b, keeping every f32 product small.
    two_pi = 2.0 * np.pi
    w64 = two_pi * np.asarray(offsets, np.float64) / fs_wide
    k_blk = 1024
    n_a = -(-n // k_blk)
    w_k = jnp.asarray((w64 * k_blk) % two_pi, jnp.float32)[:, None, None]
    w_b = jnp.asarray(w64 % two_pi, jnp.float32)[:, None, None]
    a = jnp.arange(n_a, dtype=jnp.float32)[None, :, None]
    b = jnp.arange(k_blk, dtype=jnp.float32)[None, None, :]
    ph = (jnp.mod(w_k * a, two_pi) + w_b * b
          + state.phi0[:, None, None])
    ph = jnp.mod(ph, two_pi).reshape(len(offsets), n_a * k_blk)[:, :n]
    c_m = jnp.cos(ph)
    s_m = jnp.sin(ph)
    # (x_i + j x_q) * e^{-j ph}
    mix_i = i_w[None, :] * c_m + q_w[None, :] * s_m
    mix_q = q_w[None, :] * c_m - i_w[None, :] * s_m

    stacked = jnp.stack([mix_i, mix_q], axis=1)              # (C, 2, N)
    # same FIR kernel choice as the receiver stages
    fir_fn = (jfir.fir_block_decim_mm
              if select_kernels()["mxu_fir"]
              else jfir.fir_block_decim)
    ds, new_fir = fir_fn(stacked, h, state.fir, decim)

    out = jnp.stack([ds[:, 0, :], ds[:, 1, :]], axis=-1)     # (C, N/D, 2)
    out = out.reshape(ds.shape[0], -1)                       # interleaved

    # exact per-block phase advance, computed in host float64
    step = jnp.asarray((w64 * n) % two_pi, jnp.float32)
    phi0 = jnp.mod(state.phi0 + step, two_pi)
    return out, ChannelizerState(fir=new_fir, phi0=phi0)
