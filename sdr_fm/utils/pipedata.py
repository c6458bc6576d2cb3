"""Parser for the reference's captured pipeline log (pipeData.txt).

``/root/reference/data/data/pipeData.txt`` is the only artifact in the
reference repository derived from its ACTUAL runs: a stderr capture of the
real-time mono pipeline (``threadMonoOnly``) fed 24,000,000 u8 samples of
a real off-air FM capture, with ``printRealVectorFloat``
(src/threadMonoOnly.cpp:436-443) dumping two full 102,400-sample raw input
blocks as normalized floats.

Every printed value is an exact multiple of 1/128 — the u8 normalization
``(u8 - 128) / 128`` (src/iofunc.cpp:128-135) — so the ORIGINAL u8 bytes
reconstruct exactly: ``u8 = round(x * 128) + 128``.  That recovers ~85 ms
of genuine RTL-SDR antenna capture (the recording itself was never
committed), which our tests replay through both this framework and the
compiled reference binary: the one cross-validation vector not synthesized
by us.
"""

from __future__ import annotations

import re
from typing import NamedTuple

import numpy as np

PIPEDATA_PATH = "/root/reference/data/data/pipeData.txt"


class PipeData(NamedTuple):
    iq_data_size: int        # header: full capture length in u8 samples
    block_size: int          # header: u8 samples per block
    blocks_f32: list         # printed normalized float vectors, in order
    blocks_u8: list          # exact u8 reconstruction of each


def parse(path: str = PIPEDATA_PATH) -> PipeData:
    """Parse the log: header sizes + every printed float vector."""
    iq_size = block_size = 0
    blocks: list[np.ndarray] = []
    expect_vector = False
    expect_len = 0
    with open(path) as f:
        for line in f:
            m = re.match(r"iq_data size = (\d+)", line)
            if m:
                iq_size = int(m.group(1))
                continue
            m = re.match(r"block_size = (\d+)", line)
            if m:
                block_size = int(m.group(1))
                continue
            m = re.match(r"Printing float vector of size (\d+)", line)
            if m:
                expect_vector, expect_len = True, int(m.group(1))
                continue
            if expect_vector:
                v = np.array(line.split(), dtype=np.float64)
                if len(v) != expect_len:
                    raise ValueError(
                        f"printed vector length {len(v)} != declared "
                        f"{expect_len}")
                blocks.append(v)
                expect_vector = False
    u8s = [reconstruct_u8(b) for b in blocks]
    return PipeData(iq_size, block_size, blocks, u8s)


def reconstruct_u8(x: np.ndarray) -> np.ndarray:
    """Invert the reference's u8 normalization exactly.

    ``readStdinBlockData`` computes ``(u8 - 128) / 128`` in float32
    (src/iofunc.cpp:133); the log prints 6 significant digits, which is
    exact for every representable value here (|x| <= 1, steps of 1/128).
    Raises if any value is NOT on the u8 grid (which would mean the vector
    is a processed signal, not raw input).
    """
    scaled = np.asarray(x, np.float64) * 128.0
    rounded = np.round(scaled)
    if not np.allclose(scaled, rounded, atol=1e-3):
        raise ValueError("values not on the u8 normalization grid")
    u8 = rounded + 128.0
    if u8.min() < 0 or u8.max() > 255:
        raise ValueError("reconstructed bytes outside u8 range")
    return u8.astype(np.uint8)
