"""Streaming FIR kernels as XLA convolutions.

The reference's four convolution variants (src/filter.cpp:118-223) collapse
into one primitive: ``lax.conv_general_dilated`` with

* ``window_strides=D``  — decimation (convolveBlockFastFIR),
* ``lhs_dilation=U``    — zero-stuffing upsampling (convolveBlockResampleFIR),

plus the overlap-save state convention (the trailing ``taps-1`` inputs,
src/filter.cpp:148-153).  For the rational resampler the default
implementation is a *phase-gathered window product*: because block length,
U, D and taps are static, the (output, tap) -> (input index, coefficient)
maps are compile-time constants, so the whole resampler is one gather + one
fused multiply-reduce of exactly n_out * ceil(K/U) MACs — the polyphase
minimum — with no zero-stuffed intermediate.

The polyphase gain convention is the Python model's xU
(model/fmSupportLib.py:399), not the C++ x(U+1) divergence
(src/filter.cpp:213) — see SURVEY.md section 2.5.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


#: precision of every f32 FIR product (convs and banded matmuls).  On the
#: H100, HIGH runs the banded matmuls in TF32: 2.6-3.2e-4 relative RMS vs
#: the float64 golden at the mode-0/2 block width, against 1.4-2.2e-7 at
#: HIGHEST; the cuDNN convolutions measured 0.8-2.2e-7 at either (PERF.md).
PRECISION = lax.Precision.HIGHEST


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def resample_state_len(n_taps: int, upsamp: int) -> int:
    """Natural-domain resampler state length: ceil(taps/U) - 1."""
    return _cdiv(n_taps, upsamp) - 1


def _conv1d(xc: jnp.ndarray, h_rev: jnp.ndarray, stride: int,
            lhs_dilation: int = 1,
            padding: tuple[int, int] = (0, 0)) -> jnp.ndarray:
    """Batched-capable 1D correlation via conv_general_dilated.

    ``xc`` may be (..., N); leading dims are treated as batch.
    """
    lead = xc.shape[:-1]
    lhs = xc.reshape((-1, 1, xc.shape[-1]))
    rhs = h_rev.reshape((1, 1, -1)).astype(xc.dtype)
    y = lax.conv_general_dilated(
        lhs, rhs,
        window_strides=(stride,),
        padding=[padding],
        lhs_dilation=(lhs_dilation,),
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=jnp.float32,
        precision=PRECISION,    # H100: 1.7-2.2e-7 rel RMS vs golden
    )
    return y.reshape(lead + (y.shape[-1],))


def fir_block(x: jnp.ndarray, h: jnp.ndarray,
              state: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Streaming FIR, unit stride (ref: src/filter.cpp:133-154)."""
    return fir_block_decim(x, h, state, 1)


def fir_block_multi(x: jnp.ndarray, hs: jnp.ndarray, states: jnp.ndarray
                    ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """One input through C different same-length FIRs in ONE conv.

    ``hs`` is (C, K); ``states`` is a single shared (..., K-1) carry — FIR
    state is the trailing input tail, which is identical for every arm
    filtering the same input with the same length.  Returns
    ((..., C, N), new_state).

    The receiver's stereo/pilot/RDS-channel band-passes all filter the
    same FM-demodulated signal (src/project.cpp:202-207,
    model/fmRDS.py:223): as one conv with C output features the taps ride
    the feature dimension instead of C separate C_out=1 convs.
    """
    k = hs.shape[-1]
    c = hs.shape[0]
    n = x.shape[-1]
    lead = x.shape[:-1]
    xc = jnp.concatenate([states, x], axis=-1)
    lhs = xc.reshape((-1, 1, xc.shape[-1]))
    rhs = hs[:, None, ::-1].astype(xc.dtype)           # (C, 1, K)
    y = lax.conv_general_dilated(
        lhs, rhs, window_strides=(1,), padding=[(0, 0)],
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=jnp.float32,
        precision=PRECISION,    # H100: 2.1-2.2e-7 rel RMS vs golden
    )[..., :n]
    new_state = xc[..., xc.shape[-1] - (k - 1):]
    return y.reshape(lead + (c, n)), new_state


def fir_block_decim(x: jnp.ndarray, h: jnp.ndarray, state: jnp.ndarray,
                    decim: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Streaming decimating FIR (ref: src/filter.cpp:158-188).

    y[j] = sum_n h[n] * xc[K-1 + j*decim - n], xc = [state, x].
    ``x``/``state`` may carry leading batch dims.
    """
    k = h.shape[0]
    n = x.shape[-1]
    assert n % decim == 0, (n, decim)
    xc = jnp.concatenate([state, x], axis=-1)
    y = _conv1d(xc, h[::-1], decim)[..., : n // decim]
    new_state = xc[..., xc.shape[-1] - (k - 1):]
    return y, new_state


@functools.lru_cache(maxsize=64)
def _resample_maps(n_in: int, n_taps: int, decim: int,
                   upsamp: int) -> tuple[np.ndarray, np.ndarray]:
    """Compile-time (input-window index, coefficient-selector index) maps for
    the phase-gathered resampler.  Returns (xidx (n_out, T), nidx (n_out, T))
    where nidx entries >= n_taps mark taps beyond the filter (zero coeff)."""
    t = _cdiv(n_taps, upsamp)
    n_out = n_in * upsamp // decim
    j = np.arange(n_out)
    m = j * decim
    p = m % upsamp
    q = (m - p) // upsamp + (t - 1)
    r = np.arange(t)
    nidx = p[:, None] + r[None, :] * upsamp     # tap index (may exceed K-1)
    xidx = q[:, None] - r[None, :]              # index into xc
    return xidx, nidx


def fir_block_resample(x: jnp.ndarray, h: jnp.ndarray, state: jnp.ndarray,
                       decim: int, upsamp: int,
                       use_conv: bool = False) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Streaming polyphase rational resampler, xU gain
    (ref: model/fmSupportLib.py:388-406; state convention per
    sdr_fm.golden.filters.block_fir_resample).
    """
    k = h.shape[0]
    t = _cdiv(k, upsamp)
    n = x.shape[-1]
    n_out = n * upsamp // decim
    assert n_out * decim == n * upsamp, "block length must divide evenly"
    xc = jnp.concatenate([state, x], axis=-1)

    if use_conv:
        pad_lo = k - 1 - upsamp * (t - 1)
        dilated = upsamp * (xc.shape[-1] - 1) + 1
        pad_hi = max((n_out - 1) * decim + k - pad_lo - dilated, 0)
        y = _conv1d(xc, h[::-1] * upsamp, decim, lhs_dilation=upsamp,
                    padding=(pad_lo, pad_hi))[..., :n_out]
    else:
        xidx, nidx = _resample_maps(n, k, decim, upsamp)
        # nidx/xidx are compile-time constants; h may be traced under jit
        hsel = jnp.where(jnp.asarray(nidx < k),
                         h[jnp.asarray(np.minimum(nidx, k - 1))], 0.0)
        hsel = (hsel * upsamp).astype(x.dtype)               # (n_out, T)
        xwin = xc[..., jnp.asarray(xidx)]                    # (..., n_out, T)
        # H100: 0.8e-7 rel RMS vs golden
        y = jnp.einsum("...ot,ot->...o", xwin, hsel,
                       preferred_element_type=jnp.float32,
                       precision=PRECISION).astype(x.dtype)

    new_state = xc[..., xc.shape[-1] - (t - 1):] if t > 1 else xc[..., :0]
    return y, new_state


# --- Matmul formulations -------------------------------------------------
#
# A conv with C_in = C_out = 1 never reaches the matrix units.  The classic
# im2col blocking puts every FIR on them: take U consecutive outputs per
# window,
#
#     Y[..., w, u] = sum_t X[..., w, t] * W[t, u]
#     X[..., w, t] = xc[..., w*U*D + t]          (windows, ~11% overlap)
#     W[t, u]      = h[K-1 + u*D - t]            (banded, zero elsewhere)
#
# with T_win = (U-1)*D + K.  The banded W inflates FLOPs by T_win/K
# (~2-10x) over the polyphase minimum, but it runs as one large matmul.
# U defaults to 128 output columns per window.


def _win_starts(n_win: int, stride: int, t_win: int,
                limit: int) -> np.ndarray:
    """Static window-gather index matrix (n_win, t_win), clamped."""
    idx = (np.arange(n_win)[:, None] * stride + np.arange(t_win)[None, :])
    return np.minimum(idx, limit - 1)


def _gather_windows(xc: jnp.ndarray, n_win: int, stride: int,
                    t_win: int) -> jnp.ndarray:
    """(..., L) -> (..., n_win, t_win) overlapped windows (static idx)."""
    idx = _win_starts(n_win, stride, t_win, xc.shape[-1])
    return xc[..., jnp.asarray(idx)]


@functools.lru_cache(maxsize=64)
def _decim_band_maps(n_taps: int, decim: int,
                     u_blk: int) -> tuple[np.ndarray, np.ndarray, int]:
    """(tap-index map, validity mask, T_win) for the banded decimating-FIR
    weight matrix W[t, u] = h[K-1 + u*D - t]."""
    t_win = (u_blk - 1) * decim + n_taps
    t = np.arange(t_win)[:, None]
    u = np.arange(u_blk)[None, :]
    n = n_taps - 1 + u * decim - t
    valid = (n >= 0) & (n < n_taps)
    return np.clip(n, 0, n_taps - 1), valid, t_win


def _band_matrix(h: jnp.ndarray, decim: int, u_blk: int,
                 dtype) -> tuple[jnp.ndarray, int]:
    """Banded W (T_win, u_blk) from (possibly traced) taps ``h``."""
    nmap, valid, t_win = _decim_band_maps(h.shape[0], decim, u_blk)
    w = jnp.where(jnp.asarray(valid), h[jnp.asarray(nmap)], 0.0)
    return w.astype(dtype), t_win


def fir_block_decim_mm(x: jnp.ndarray, h: jnp.ndarray, state: jnp.ndarray,
                       decim: int, u_blk: int = 128
                       ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Matmul drop-in for :func:`fir_block_decim` (bit-comparable outputs;
    HIGH-precision matmul like the conv path)."""
    k = h.shape[0]
    n = x.shape[-1]
    assert n % decim == 0, (n, decim)
    n_out = n // decim
    u_blk = min(u_blk, n_out)
    n_win = _cdiv(n_out, u_blk)
    xc = jnp.concatenate([state, x], axis=-1)
    w, t_win = _band_matrix(h, decim, u_blk, x.dtype)
    xw = _gather_windows(xc, n_win, u_blk * decim, t_win)
    # H100: 1.4-2.2e-7 rel RMS vs golden (TF32 at HIGH: ~3e-4)
    y = jnp.einsum("...wt,tu->...wu", xw, w,
                   preferred_element_type=jnp.float32,
                   precision=PRECISION).astype(x.dtype)
    y = y.reshape(y.shape[:-2] + (n_win * u_blk,))[..., :n_out]
    new_state = xc[..., xc.shape[-1] - (k - 1):]
    return y, new_state


def split_bf16(w: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """f32 ``w`` as ``hi + lo``, both bfloat16, ~2^-17 relative error.

    ``hi`` rounds ``w`` to bf16 with integer bit arithmetic, not with an
    f32->bf16->f32 round trip: XLA's GPU pipeline may drop such a round
    trip as excess precision, which leaves ``lo == 0`` and the weights at
    bf16 precision (measured on the H100: 7.8e-3 audio error vs golden
    when the taps are runtime arguments)."""
    bits = lax.bitcast_convert_type(w.astype(jnp.float32), jnp.uint32)
    hi = lax.bitcast_convert_type((bits + jnp.uint32(0x8000))
                                  & jnp.uint32(0xFFFF0000), jnp.float32)
    return hi.astype(jnp.bfloat16), (w - hi).astype(jnp.bfloat16)


def fir_block_decim_mm_bf16x(x: jnp.ndarray, h: jnp.ndarray,
                             state: jnp.ndarray, decim: int,
                             u_blk: int = 128
                             ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Banded-matmul decimating FIR for EXACT bf16 inputs (u8 front-end).

    A u8-normalized sample ``(x - 128)/128`` is an 8-bit signed integer
    times a power of two — exactly representable in bfloat16 (8 mantissa
    bits).  When the x side carries no rounding error, only the WEIGHTS
    need splitting: ``W = W_hi + W_lo`` (two bf16 matmul passes
    accumulating in f32) reaches ~2^-17 relative weight error with bf16
    operands, at HALF the window-gather traffic of the f32 path.  This
    is the serving-regime front-end (the raw SDR stream is
    u8, src/iofunc.cpp:128-135); inputs that are not bf16-exact must use
    :func:`fir_block_decim_mm` instead.

    ``x``/``state`` are bfloat16; returns (f32 outputs, bf16 tail state).
    """
    k = h.shape[0]
    n = x.shape[-1]
    assert x.dtype == jnp.bfloat16, x.dtype
    assert n % decim == 0, (n, decim)
    n_out = n // decim
    u_blk = min(u_blk, n_out)
    n_win = _cdiv(n_out, u_blk)
    xc = jnp.concatenate([state.astype(jnp.bfloat16), x], axis=-1)
    w32, t_win = _band_matrix(h, decim, u_blk, jnp.float32)
    w_hi, w_lo = split_bf16(w32)
    xw = _gather_windows(xc, n_win, u_blk * decim, t_win)
    # one matmul over [W_hi | W_lo] (not two): the window matrix — the
    # dominant operand — is read once, and the hi/lo partials come back as
    # adjacent output columns to be summed.  bf16 operands with f32
    # accumulation (exact products): the split weights set the error,
    # measured against golden by chip_smoke.py (PERF.md)
    y2 = jnp.einsum("...wt,tu->...wu", xw,
                    jnp.concatenate([w_hi, w_lo], axis=-1),
                    preferred_element_type=jnp.float32,
                    precision=lax.Precision.DEFAULT)
    y = y2[..., :u_blk] + y2[..., u_blk:]
    y = y.reshape(y.shape[:-2] + (n_win * u_blk,))[..., :n_out]
    new_state = xc[..., xc.shape[-1] - (k - 1):]
    return y, new_state


def fir_block_decim_mm_interleaved(x_int: jnp.ndarray, h: jnp.ndarray,
                                   st2: jnp.ndarray, decim: int,
                                   u_blk: int = 128
                                   ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """RF front-end variant of :func:`fir_block_decim_mm` that gathers its
    windows straight from the INTERLEAVED I,Q,... signal.

    ``x_int`` is (..., 2*N) interleaved; ``st2`` is the (..., 2, K-1)
    stacked I/Q overlap-save state.  The gather's index map reads the
    even/odd positions, so no deinterleaved copy materializes.  The state is prepended interleaved
    (300 floats/channel), keeping every window uniform.  Outputs and new
    state are bit-identical to fir_block_decim_mm on the deinterleaved
    input (same W, same summation order).
    """
    k = h.shape[0]
    n = x_int.shape[-1] // 2
    assert n % decim == 0, (n, decim)
    n_out = n // decim
    u_blk = min(u_blk, n_out)
    n_win = _cdiv(n_out, u_blk)
    lead = st2.shape[:-2]
    st_int = jnp.moveaxis(st2, -2, -1).reshape(lead + (2 * (k - 1),))
    xi = jnp.concatenate([st_int, x_int], axis=-1)

    w, t_win = _band_matrix(h, decim, u_blk, x_int.dtype)
    idx = _win_starts(n_win, u_blk * decim, t_win, n + k - 1)
    idx2 = np.stack([2 * idx, 2 * idx + 1])          # (2, n_win, t_win)
    xw = xi[..., jnp.asarray(idx2)]                  # (..., 2, n_win, t_win)
    # same product as fir_block_decim_mm (H100: 1.4-2.2e-7 rel RMS)
    y = jnp.einsum("...wt,tu->...wu", xw, w,
                   preferred_element_type=jnp.float32,
                   precision=PRECISION).astype(x_int.dtype)
    y = y.reshape(lead + (2, n_win * u_blk))[..., :n_out]

    tail = x_int[..., x_int.shape[-1] - 2 * (k - 1):]
    new_st = jnp.moveaxis(tail.reshape(lead + (k - 1, 2)), -1, -2)
    return y, new_st


def fir_block_multi_mm(x: jnp.ndarray, hs: jnp.ndarray,
                       states: jnp.ndarray, u_blk: int = 128
                       ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Matmul drop-in for :func:`fir_block_multi`: C same-length filters over
    one input as a single (T_win x C*U) matmul."""
    c, k = hs.shape
    n = x.shape[-1]
    u_blk = min(u_blk, n)
    n_win = _cdiv(n, u_blk)
    xc = jnp.concatenate([states, x], axis=-1)
    nmap, valid, t_win = _decim_band_maps(k, 1, u_blk)
    # hs.T is (K, C); index taps along axis 0 with nmap (T_win, U) ->
    # (T_win, U, C); reorder to (T_win, C, U)
    w3 = jnp.where(jnp.asarray(valid)[..., None],
                   hs.T[jnp.asarray(nmap)], 0.0)
    w3 = jnp.moveaxis(w3, -1, 1).astype(x.dtype)      # (T_win, C, U)
    xw = _gather_windows(xc, n_win, u_blk, t_win)
    # H100: 1.6-2.2e-7 rel RMS vs golden (TF32 at HIGH: ~3e-4)
    y = jnp.einsum("...wt,tcu->...cwu", xw, w3,
                   preferred_element_type=jnp.float32,
                   precision=PRECISION).astype(x.dtype)
    y = y.reshape(y.shape[:-2] + (n_win * u_blk,))[..., :n]
    new_state = xc[..., xc.shape[-1] - (k - 1):]
    return y, new_state


@functools.lru_cache(maxsize=64)
def _resample_band_np(n_taps: int, decim: int,
                      upsamp: int) -> tuple[np.ndarray, np.ndarray,
                                            np.ndarray, int]:
    """Static scatter maps for the banded resampler weight matrix.

    Output block = one full phase cycle (U outputs), window stride D
    inputs: y[w*U + u] = sum_r h[p_u + r*U] * xc[w*D + c_u + (t-1) - r]
    with p_u = (u*D) mod U, c_u = (u*D - p_u)/U, t = ceil(K/U).
    Returns (o_idx (t, U), n_idx (t, U), valid (t, U), T_win)."""
    t = _cdiv(n_taps, upsamp)
    u = np.arange(upsamp)
    p = (u * decim) % upsamp
    c = (u * decim - p) // upsamp
    r = np.arange(t)[:, None]
    n_idx = p[None, :] + r * upsamp               # tap index
    o_idx = c[None, :] + (t - 1) - r              # window offset
    valid = n_idx < n_taps
    t_win = int(c.max()) + t
    return o_idx, np.clip(n_idx, 0, n_taps - 1), valid, t_win


def fir_block_resample_mm(x: jnp.ndarray, h: jnp.ndarray,
                          state: jnp.ndarray, decim: int, upsamp: int
                          ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Matmul drop-in for :func:`fir_block_resample` (xU gain).

    Requires the block length divisible by ``decim`` (every mode's
    default block satisfies this — config.if_block_multiple); falls back
    to the gather-einsum path otherwise."""
    k = h.shape[0]
    t = _cdiv(k, upsamp)
    n = x.shape[-1]
    if n % decim != 0:
        return fir_block_resample(x, h, state, decim, upsamp)
    n_win = n // decim
    o_idx, n_idx, valid, t_win = _resample_band_np(k, decim, upsamp)
    xc = jnp.concatenate([state, x], axis=-1)
    vals = jnp.where(jnp.asarray(valid),
                     h[jnp.asarray(n_idx)] * upsamp, 0.0)
    w = jnp.zeros((t_win, upsamp), jnp.float32).at[
        jnp.asarray(o_idx), jnp.asarray(np.broadcast_to(
            np.arange(upsamp)[None, :], o_idx.shape))].add(vals)
    xw = _gather_windows(xc, n_win, decim, t_win)
    # H100: 1.7-1.8e-7 rel RMS vs golden (TF32 at HIGH: ~3e-4)
    y = jnp.einsum("...wt,tu->...wu", xw, w.astype(x.dtype),
                   preferred_element_type=jnp.float32,
                   precision=PRECISION).astype(x.dtype)
    y = y.reshape(y.shape[:-2] + (n_win * upsamp,))
    new_state = xc[..., xc.shape[-1] - (t - 1):] if t > 1 else xc[..., :0]
    return y, new_state


def allpass_delay(x: jnp.ndarray,
                  state: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Pure delay by len(state) samples (ref: model/fmSupportLib.py:291-295)."""
    d = state.shape[-1]
    y = jnp.concatenate([state, x[..., : x.shape[-1] - d]], axis=-1)
    new_state = x[..., x.shape[-1] - d:]
    return y, new_state
