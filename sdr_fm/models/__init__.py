"""Receiver models: jitted end-to-end processing graphs.

The reference's thread/queue pipeline (src/project.cpp:384-500) becomes a
single jitted block program; streaming is ``lax.scan`` over blocks with an
explicit state pytree (SURVEY.md §7 architecture stance).
"""

from sdr_fm.models import rds_decode  # noqa: F401
from sdr_fm.models.receiver import (  # noqa: F401
    Receiver,
    ReceiverCoeffs,
    ReceiverState,
    design_coeffs,
    init_state,
    make_block_fn,
    process_block,
    run_blocks_scan,
)
