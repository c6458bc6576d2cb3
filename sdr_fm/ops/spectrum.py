"""Spectral analysis on the device: matmul DFT and rfft Bartlett PSD.

Replaces the reference Fourier stack (src/fourier.cpp: DFT, three FFT
variants, estimatePSD).  A direct DFT of a 512-point segment batch is a
single (n_seg, 512) @ (512, 512) complex matmul, which runs on the matrix
units instead of a hand-written radix-2 FFT; XLA's own FFT is used where
asymptotics matter.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

NFFT_DEFAULT = 512  # include/dy4.h:27


@functools.lru_cache(maxsize=8)
def _dft_matrix(n: int) -> np.ndarray:
    k = np.arange(n)
    return np.exp(-2j * np.pi * np.outer(k, k) / n).astype(np.complex64)


def dft_matmul(x: jnp.ndarray) -> jnp.ndarray:
    """DFT of the last axis as a matmul (ref semantics src/fourier.cpp:15-23)."""
    n = x.shape[-1]
    w = jnp.asarray(_dft_matrix(n))
    return jnp.einsum("...k,km->...m", x.astype(jnp.complex64), w)


def idft_matmul(xf: jnp.ndarray) -> jnp.ndarray:
    """Inverse DFT with 1/N scaling (ref: src/fourier.cpp:132-141)."""
    n = xf.shape[-1]
    w = jnp.conj(jnp.asarray(_dft_matrix(n)))
    return jnp.einsum("...k,km->...m", xf.astype(jnp.complex64), w) / n


def hann_sin2(n: int) -> np.ndarray:
    i = np.arange(n)
    return (np.sin(i * np.pi / n) ** 2).astype(np.float32)


def estimate_psd(samples: jnp.ndarray, nfft: int = NFFT_DEFAULT,
                 fs: float = 1.0,
                 use_matmul_dft: bool = False) -> tuple[np.ndarray, jnp.ndarray]:
    """Bartlett PSD in dB/Hz, positive frequencies — device-side equivalent
    of the golden estimate (model/fmSupportLib.py:554-631).

    ``use_matmul_dft=True`` evaluates the segment DFTs as one real-valued
    (n_seg, nfft) x (nfft, nfft) matmul pair against cos/sin bases — at the
    NFFT=512 the reference uses (include/dy4.h:27) this is one matmul and
    replaces the reference's three hand-written FFT variants
    (src/fourier.cpp:175-260).
    """
    n_seg = samples.shape[-1] // nfft
    half = nfft // 2
    seg = samples[..., : n_seg * nfft].reshape(
        samples.shape[:-1] + (n_seg, nfft)) * jnp.asarray(hann_sin2(nfft))
    if use_matmul_dft:
        w = _dft_matrix(nfft)[:, :half]
        wr = jnp.asarray(np.ascontiguousarray(w.real))
        wi = jnp.asarray(np.ascontiguousarray(w.imag))
        re = jnp.matmul(seg, wr, preferred_element_type=jnp.float32)
        im = jnp.matmul(seg, wi, preferred_element_type=jnp.float32)
        mag2 = re * re + im * im
    else:
        xf = jnp.fft.fft(seg, nfft, axis=-1)[..., :half]
        mag2 = jnp.abs(xf) ** 2
    psd = 2.0 * mag2 / (fs * nfft / 2)
    psd_db = 10.0 * jnp.log10(psd)
    freq = np.arange(0, fs / 2, fs / nfft)[:half]
    return freq, psd_db.mean(axis=-2)
