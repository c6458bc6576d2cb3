"""DSP primitives on JAX/XLA (the PLL's GPU kernel in sdr_fm.ops.pll_kernel).

Design mapping from the reference's kernel library (src/filter.cpp):

=====================================  =====================================
Reference kernel                       JAX formulation
=====================================  =====================================
convolveFIR / convolveBlockFIR         XLA conv_general_dilated (stride 1)
convolveBlockFastFIR (decimating)      conv_general_dilated, window_strides=D
convolveBlockResampleFIR (polyphase)   phase-gathered window dot (default) or
                                       conv with lhs_dilation=U, strides=D
fmDemod                                vectorized elementwise
fmPLL                                  lax.scan recurrence (+ GPU kernel)
allPass                                static slice + concat
upsample/downsample                    lhs_dilation / strided slice
DFT / FFT / estimatePSD                matmul DFT / jnp.fft / rfft PSD
=====================================  =====================================

All streaming ops keep the reference's ``(y, new_state)`` contract with the
state being the trailing ``taps-1`` input samples (or its natural-domain
equivalent for the polyphase resampler), so device state pytrees are
checkpointable and bit-comparable to the golden model.
"""

from sdr_fm.ops.fir import (  # noqa: F401
    fir_block,
    fir_block_decim,
    fir_block_resample,
    allpass_delay,
    resample_state_len,
)
from sdr_fm.ops.demod import fm_demod_quad, fm_demod_arctan  # noqa: F401
from sdr_fm.ops.pll import PllParams, pll_init, pll_block  # noqa: F401
from sdr_fm.ops.spectrum import dft_matmul, estimate_psd  # noqa: F401
