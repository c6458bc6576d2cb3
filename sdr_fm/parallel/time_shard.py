"""Time-parallel receive: one recording split across chips with halo exchange.

The reference's whole design is overlap-save streaming — every stateful op
carries a small trailing-input state (SURVEY.md §2.3 row 2).  Splitting a
long recording into S contiguous shards therefore needs each shard to start
with the state the previous shard would have handed it.  Two classes of op:

* **linear/FIR state** (FIR tails, demod last-IQ, allpass delay): fully
  determined by the last few *input* samples — covered exactly by prefixing
  each shard with an input overlap from its left neighbor (one ``ppermute``
  inside ``shard_map``).
* **sequential recurrences** (PLL; ref src/filter.cpp:52-72): state is a
  function of the whole past.  The overlap gives the PLL a re-lock runway;
  after lock the NCO converges to the same phase trajectory (the pilot is a
  physical oscillator both shards track), so outputs agree after the
  overlap to PLL-tracking tolerance, not bit-exactly (SURVEY.md §7 step 8's
  "re-lock with overlap discard" plan).

Each shard runs the SAME jitted block DAG as a single device; the only
collective on the hot path is the single halo ``ppermute`` per program.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sdr_fm import config as cfg
from sdr_fm.models import receiver as rx
from sdr_fm.parallel.channel import put_sharded


def default_block_if(mc: cfg.ModeConfig, with_rds: bool = False) -> int:
    """Smallest whole-multiple IF block length >= 5000 samples."""
    mult = mc.if_block_multiple(with_rds)
    return -(-5000 // mult) * mult


def time_sharded_receive(iq: np.ndarray, mesh: Mesh,
                         mode: int | cfg.Mode = 0, stereo: bool = True,
                         with_rds: bool = False,
                         overlap_if: Optional[int] = None,
                         axis: str = "time",
                         batch_axis: Optional[str] = None,
                         block_if: Optional[int] = None) -> rx.BlockOutputs:
    """Process one recording time-sharded over ``mesh`` axis ``axis``.

    ``iq``: (n,) normalized interleaved IQ; n must divide evenly into
    S = mesh.shape[axis] segments, each a whole number of ``block_if``-IF
    blocks.  Within a shard the segment streams through a ``lax.scan`` of
    block steps — device memory stays O(block), so arbitrarily long
    recordings shard without materializing a segment-sized intermediate.
    ``overlap_if`` is the per-shard warm-up prefix in IF samples (default
    the smallest whole-block count >= 6k samples: beyond FIR depth with
    pilot-PLL re-lock runway); it is rounded up to whole blocks and its
    outputs are discarded.  Returns globally assembled outputs laid out
    exactly like a contiguous run.

    With ``batch_axis`` set, ``iq`` is (C, n): a channel batch sharded over
    a second mesh axis — time and channel parallelism composed on one 2D
    mesh (the dp x sp layout of SURVEY.md §2.3).
    """
    mc = cfg.get_mode_config(mode)
    with_rds = with_rds and mc.rds is not None
    s = mesh.shape[axis]

    mult = mc.if_block_multiple(with_rds)
    if block_if is None:
        block_if = default_block_if(mc, with_rds)
    assert block_if % mult == 0, (block_if, mult)
    if overlap_if is None:
        overlap_if = 6000
    # overlap must be whole blocks so the scan can discard whole steps
    n_skip_blocks = -(-overlap_if // block_if)
    overlap_if = n_skip_blocks * block_if

    raw_per_if = 2 * mc.rf_decim
    block_raw = block_if * raw_per_if
    n = iq.shape[-1]
    seg = n // s
    assert seg * s == n, "recording must split evenly across shards"
    assert seg % block_raw == 0, (
        f"segment of {seg} raw samples is not a whole number of "
        f"{block_raw}-sample blocks")
    halo_raw = overlap_if * raw_per_if
    assert halo_raw <= seg, "overlap larger than a segment"
    n_blocks = seg // block_raw + n_skip_blocks

    coeffs = rx.design_coeffs(mc)
    # same kernel selection as the contiguous paths (Receiver.run /
    # run_blocks_scan): sharded and contiguous runs must pick IDENTICAL
    # kernels or the bit-match invariant on the linear arms breaks at the
    # kernel-vs-kernel roundoff level
    sel = rx.select_kernels()

    # only enabled arms are returned — zero-length placeholders cannot carry
    # a sharded PartitionSpec
    arms = ["fm_demod", "mono"]
    if stereo:
        arms += ["left", "right"]
    if with_rds:
        arms += ["rds_symbols"]

    spec = P(batch_axis, axis) if batch_axis else P(axis)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=spec,
        out_specs={a: spec for a in arms},
        check_vma=False)
    def run_shard(iq_local: jnp.ndarray) -> dict:
        # left neighbor's trailing halo_raw samples; shard 0 receives zeros
        tail = iq_local[..., -halo_raw:]
        halo = lax.ppermute(tail, axis, [(i, i + 1) for i in range(s - 1)])
        ext = jnp.concatenate([halo, iq_local], axis=-1)
        lead = ext.shape[:-1]
        blocks = jnp.moveaxis(
            ext.reshape(lead + (n_blocks, block_raw)), -2, 0)
        init = rx.init_state(mc, batch_shape=lead)

        def step(st, blk):
            out, st = rx.process_block(blk, coeffs, st, mc, stereo=stereo,
                                       with_rds=with_rds, **sel)
            return st, {a: out._asdict()[a] for a in arms}

        # warm-up scan over the halo blocks (outputs discarded)
        warm_state, _ = lax.scan(step, init, blocks[:n_skip_blocks])
        # shard 0's halo is zeros, which warms the FIR states correctly but
        # walks the PLL (zero input still advances its oscillator): reset
        # shard 0 to the EXACT fresh state a contiguous run starts from
        is_first = lax.axis_index(axis) == 0
        state = jax.tree.map(
            lambda i0, w: jnp.where(is_first, i0, w), init, warm_state)
        _, outs = lax.scan(step, state, blocks[n_skip_blocks:])
        # flatten time: (n_blk, ..., per) -> (..., n_blk * per)
        kept = {}
        for a in arms:
            o = jnp.moveaxis(outs[a], 0, -2)
            kept[a] = o.reshape(lead + (-1,))
        return kept

    sharding = NamedSharding(mesh, spec)
    if isinstance(iq, jax.Array) and getattr(iq, "committed", False):
        # already a (possibly multi-process) global sharded array — the
        # jax.distributed path builds it with
        # make_array_from_process_local_data, where a host-side device_put
        # across processes is not possible
        iq_dev = iq
    else:
        iq_dev = put_sharded(np.asarray(iq, dtype=np.float32), sharding)
    res = run_shard(iq_dev)
    empty = jnp.zeros((0,), jnp.float32)
    return rx.BlockOutputs(**{f: res.get(f, empty)
                              for f in rx.BlockOutputs._fields})


def time_sharded_receive_chunked(iq: np.ndarray, mesh: Mesh,
                                 mode: int | cfg.Mode = 0,
                                 stereo: bool = True,
                                 with_rds: bool = False,
                                 overlap_if: Optional[int] = None,
                                 axis: str = "time",
                                 batch_axis: Optional[str] = None,
                                 block_if: Optional[int] = None,
                                 chunk_blocks: int = 32):
    """Chunk-streaming variant of :func:`time_sharded_receive`.

    Generator yielding per-chunk output dicts (arm name -> host numpy of
    shape ``(S, [C,] chunk*out_per_block)``); device memory is O(S x chunk)
    for in/outputs however long the recording — the full-capture answer to
    BASELINE.json's 1-hour pod-scale config, where the single-shot path
    would materialize the whole stacked output.  Assemble with
    :func:`assemble_time_chunks` — bit-identical to the single-shot result.

    Same split semantics as the single-shot path: the per-shard warm-up
    halo is the left segment's tail (host-sliced here instead of
    ``ppermute``-exchanged — identical values, and the overlap rounds to
    whole blocks so the halo IS the warm-up block set), shard 0 resets to
    the fresh state after its zero-halo warm-up, and the same auto kernel
    selection as contiguous runs.
    """
    mc = cfg.get_mode_config(mode)
    with_rds = with_rds and mc.rds is not None
    s = mesh.shape[axis]

    mult = mc.if_block_multiple(with_rds)
    if block_if is None:
        block_if = default_block_if(mc, with_rds)
    assert block_if % mult == 0, (block_if, mult)
    if overlap_if is None:
        overlap_if = 6000
    n_skip_blocks = -(-overlap_if // block_if)

    raw_per_if = 2 * mc.rf_decim
    block_raw = block_if * raw_per_if
    halo_raw = n_skip_blocks * block_raw
    n = iq.shape[-1]
    seg = n // s
    assert seg * s == n, "recording must split evenly across shards"
    assert seg % block_raw == 0, (seg, block_raw)
    assert halo_raw <= seg, "overlap larger than a segment"
    blocks_per_seg = seg // block_raw

    coeffs = rx.design_coeffs(mc)
    sel = rx.select_kernels()
    arms = ["fm_demod", "mono"]
    if stereo:
        arms += ["left", "right"]
    if with_rds:
        arms += ["rds_symbols"]

    iq = np.asarray(iq, dtype=np.float32)
    batched = batch_axis is not None
    # host-side (S, [C,] seg) views: shard s <- contiguous segment s
    segs = np.moveaxis(iq.reshape(iq.shape[:-1] + (s, seg)), -2, 0)

    # shard dim FIRST everywhere (arrays and state): spec by position
    in_spec = P(axis, batch_axis) if batched else P(axis)
    state_spec = jax.tree.map(lambda _: in_spec, rx.init_state(mc))
    sharding = NamedSharding(mesh, in_spec)

    def _scan_blocks(st, blocks):
        def step(c, blk):
            out, c = rx.process_block(blk, coeffs, c, mc, stereo=stereo,
                                      with_rds=with_rds, **sel)
            return c, {a: out._asdict()[a] for a in arms}
        return lax.scan(step, st, blocks)

    @jax.jit
    @functools.partial(shard_map, mesh=mesh, in_specs=in_spec,
                       out_specs=state_spec, check_vma=False)
    def warmup(halo_local):
        x = halo_local[0]                     # ([C_local,] halo_raw)
        lead = x.shape[:-1]
        blocks = jnp.moveaxis(
            x.reshape(lead + (n_skip_blocks, block_raw)), -2, 0)
        init = rx.init_state(mc, batch_shape=lead)
        warm, _ = _scan_blocks(init, blocks)
        # shard 0's halo is zeros — reset to the exact fresh state a
        # contiguous run starts from (same rule as the single-shot path)
        is_first = lax.axis_index(axis) == 0
        st = jax.tree.map(lambda i0, w: jnp.where(is_first, i0, w),
                          init, warm)
        return jax.tree.map(lambda v: v[None], st)

    @jax.jit
    @functools.partial(shard_map, mesh=mesh,
                       in_specs=(state_spec, in_spec),
                       out_specs=(state_spec, {a: in_spec for a in arms}),
                       check_vma=False)
    def chunk_step(st_local, iq_local):
        st = jax.tree.map(lambda v: v[0], st_local)
        x = iq_local[0]                       # ([C_local,] cb*block_raw)
        lead = x.shape[:-1]
        cb = x.shape[-1] // block_raw
        blocks = jnp.moveaxis(x.reshape(lead + (cb, block_raw)), -2, 0)
        st, outs = _scan_blocks(st, blocks)
        kept = {a: jnp.moveaxis(outs[a], 0, -2).reshape(lead + (-1,))[None]
                for a in arms}                # (1, [C_local,] cb*per)
        return jax.tree.map(lambda v: v[None], st), kept

    # halo per shard: the left segment's trailing halo_raw samples (zeros
    # for shard 0) — the exact values the single-shot ppermute delivers;
    # the overlap rounds to whole blocks, so the halo IS the warm-up input
    halo = np.concatenate(
        [np.zeros_like(segs[:1, ..., -halo_raw:]),
         segs[:-1, ..., -halo_raw:]], axis=0)

    def _put(a):
        return put_sharded(np.ascontiguousarray(a), sharding)

    state = warmup(_put(halo))
    for k0 in range(0, blocks_per_seg, chunk_blocks):
        k1 = min(k0 + chunk_blocks, blocks_per_seg)
        chunk = segs[..., k0 * block_raw: k1 * block_raw]
        state, outs = chunk_step(state, _put(np.ascontiguousarray(chunk)))
        yield {a: np.asarray(v) for a, v in outs.items()}


def assemble_time_chunks(chunks: list[dict]) -> dict:
    """Reassemble ``time_sharded_receive_chunked`` outputs into the
    single-shot layout: arm -> ``([C,] S*total_per)`` with shard-major
    time, exactly like :func:`time_sharded_receive`."""
    out = {}
    for a in chunks[0]:
        cat = np.concatenate([c[a] for c in chunks], axis=-1)  # (S,[C],T)
        flat = np.moveaxis(cat, 0, -2)                         # ([C],S,T)
        out[a] = flat.reshape(flat.shape[:-2] + (-1,))
    return out
