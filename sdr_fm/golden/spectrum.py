"""Golden spectral analysis: DFT and Bartlett-method PSD estimate.

Reference: model/fmSupportLib.py:534-631 (DFT, estimatePSD); the C++ Fourier
stack (src/fourier.cpp) implements the same math plus three FFT variants.
On the device the DFT is a matmul and the FFT is XLA's — see
sdr_fm.ops.spectrum.
"""

from __future__ import annotations

import numpy as np


def dft(x: np.ndarray) -> np.ndarray:
    """Direct DFT via the exp(-2*pi*i*k*m/N) matrix
    (ref: model/fmSupportLib.py:534-548, src/fourier.cpp:15-23)."""
    n = len(x)
    k = np.arange(n)
    w = np.exp(-2j * np.pi * np.outer(k, k) / n)
    return w @ np.asarray(x, dtype=np.complex128)


def idft(xf: np.ndarray) -> np.ndarray:
    """Inverse DFT with 1/N scaling (ref: src/fourier.cpp:132-141)."""
    n = len(xf)
    k = np.arange(n)
    w = np.exp(2j * np.pi * np.outer(k, k) / n)
    return (w @ np.asarray(xf, dtype=np.complex128)) / n


def hann_sin2(n: int) -> np.ndarray:
    """The reference's sin^2 Hann window (model/fmSupportLib.py:568-570)."""
    i = np.arange(n)
    return np.sin(i * np.pi / n) ** 2


def estimate_psd(samples: np.ndarray, nfft: int, fs: float
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Bartlett-method PSD in dB/Hz over positive frequencies
    (ref: model/fmSupportLib.py:554-631, src/fourier.cpp:44-128).

    Segments of length ``nfft`` are Hann-windowed, FFT'd, folded to the
    positive half with doubled power, converted to dB, then averaged.
    Returns (freq, psd) with ``nfft/2`` bins.
    """
    samples = np.asarray(samples, dtype=np.float64)
    n_seg = len(samples) // nfft
    half = nfft // 2
    win = hann_sin2(nfft)
    seg = samples[: n_seg * nfft].reshape(n_seg, nfft) * win
    xf = np.fft.fft(seg, nfft, axis=1)[:, :half]
    psd = 2.0 * (np.abs(xf) ** 2) / (fs * nfft / 2)
    psd_db = 10.0 * np.log10(psd)
    freq = np.arange(0, fs / 2, fs / nfft)[:half]
    return freq, psd_db.mean(axis=0)
