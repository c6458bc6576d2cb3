"""Numpy golden model — the CPU-runnable correctness oracle.

Clean-room reimplementation of the reference's Python model layer
(model/fmSupportLib.py and friends): coefficient design, stateful streaming
FIR kernels, FM discriminators, PLL, and the RDS symbol/bit/frame chain.
Everything here is plain float64 numpy with explicit ``(y, state)`` streaming
contracts; the JAX ops in ``sdr_fm.ops`` are tested block-by-block against
these functions, and stream-vs-contiguous equivalence is property-tested the
same way the reference validated its block convolutions (SURVEY.md section 4).
"""

from sdr_fm.golden.filters import (  # noqa: F401
    lowpass_taps,
    bandpass_taps,
    rrc_taps,
    fir_full,
    block_fir,
    block_fir_decim,
    block_fir_resample,
    allpass_delay,
)
from sdr_fm.golden.demod import fm_demod_quad, fm_demod_arctan  # noqa: F401
from sdr_fm.golden.pll import PllState, fm_pll  # noqa: F401
from sdr_fm.golden.rds import (  # noqa: F401
    PARITY_MATRIX,
    SYNDROMES,
    gf2_syndrome,
    frame_sync,
    cdr,
    manchester_decode,
    diff_decode,
)
from sdr_fm.golden.spectrum import dft, estimate_psd  # noqa: F401
