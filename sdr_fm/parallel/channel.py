"""Channel-parallel receive: a batch of independent FM stations over a mesh.

The data-parallel axis the reference lacks (SURVEY.md §2.3 "Data
parallelism (absent)"): every op in sdr_fm.models.receiver supports leading
batch dims, so scaling to C channels over D devices is pure sharding — each
device runs the block scan on its own channels (``shard_map``, so the GPU
kernel, an opaque custom call to the partitioner, also runs per shard),
with zero collectives on the hot path.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import numpy as np
from jax import lax
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sdr_fm import config as cfg
from sdr_fm.models import receiver as rx


def put_sharded(host: np.ndarray, sharding: NamedSharding) -> jax.Array:
    """Host array -> global array laid out by ``sharding``, each device's
    shard copied straight from the host (no staging of the whole array on
    one device).  Only this process's addressable shards are read, so it
    also builds multi-process arrays."""
    return jax.make_array_from_callback(host.shape, sharding,
                                        lambda idx: host[idx])


@functools.lru_cache(maxsize=16)
def _sharded_scan(mesh: Mesh, axis: str, mc: cfg.ModeConfig, stereo: bool,
                  with_rds: bool, kernels: tuple):
    """Jitted per-shard block scan: (blocks, coeffs, state) -> (outs,
    state), blocks (n_blocks, C, block_len) sharded over C."""
    sel = dict(kernels)

    @jax.jit
    @functools.partial(shard_map, mesh=mesh,
                       in_specs=(P(None, axis, None), P(), P(axis)),
                       out_specs=(P(None, axis), P(axis)), check_vma=False)
    def run(blocks, coeffs, state):
        def step(st, blk):
            out, st = rx.process_block(blk, coeffs, st, mc, stereo=stereo,
                                       with_rds=with_rds, **sel)
            return st, out
        state, outs = lax.scan(step, state, blocks)
        return outs, state
    return run


def channel_sharded_run(iq_channels: np.ndarray, mesh: Mesh,
                        mode: int | cfg.Mode = 0, stereo: bool = True,
                        with_rds: bool = False,
                        block_size: Optional[int] = None,
                        axis: str = "ch"):
    """Run C independent channels sharded over ``mesh`` axis ``axis``.

    ``iq_channels``: (C, n_samples) interleaved IQ — normalized float, or
    RAW uint8 straight off the SDRs (the serving shape: u8 stays u8, is
    normalized on-device, and the host->device stream is a quarter of the
    f32 bytes).  C must be a multiple of the mesh axis size.  Returns
    (BlockOutputs, final_state) with outputs stacked (n_blocks, C,
    out_len) and every array sharded over C.  Each device receives only
    its own channels, straight from the host.
    """
    mc = cfg.get_mode_config(mode)
    with_rds = with_rds and mc.rds is not None
    if block_size is None:
        block_size = mc.default_block_size(with_rds)

    c, n = iq_channels.shape
    n_blocks = n // block_size
    blocks = iq_channels[:, : n_blocks * block_size]
    if blocks.dtype != np.uint8:
        blocks = blocks.astype(np.float32)
    blocks = np.moveaxis(blocks.reshape(c, n_blocks, block_size), 1, 0)

    iq_dev = put_sharded(np.ascontiguousarray(blocks),
                         NamedSharding(mesh, P(None, axis, None)))

    coeffs = rx.design_coeffs(mc)
    # zero state made in place, already sharded over the channel axis
    state = jax.jit(lambda: rx.init_state(mc, batch_shape=(c,)),
                    out_shardings=NamedSharding(mesh, P(axis)))()

    run = _sharded_scan(mesh, axis, mc, stereo, with_rds,
                        tuple(sorted(rx.select_kernels().items())))
    return run(iq_dev, coeffs, state)
