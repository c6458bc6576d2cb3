"""The PLL recurrence as one GPU kernel (Pallas, Triton route).

The PLL's per-sample dependency chain (ref fmPll, src/filter.cpp:32-80)
cannot be parallelised over time.  As a ``lax.scan`` every few steps are
one iteration of an XLA while-loop, i.e. a kernel launch plus a loop
predicate read back by the host; a mode-0 block has 5,760 steps.  Here the
whole block runs inside one kernel: each program owns a power-of-two tile
of lanes (channel x PLL arm, one lane per thread), the time loop runs in
registers (``lax.fori_loop``), and only the oscillator angle is written
out.  The step itself is ``ops.pll.pll_step``, the same function the scan
runs.

Input is read ahead one time tile at a time: while the ``tile_t`` steps
of tile i run on rows already in registers, the loads of tile i+1 are in
flight, so no step waits on device memory.

Layout: ``xs`` is time-major (T, L) with lanes contiguous, so each step's
load and store are coalesced.  L is padded to a whole number of lane
tiles and T to a whole number of time tiles plus one (the read-ahead of
the last tile); the padding is sliced off.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from sdr_fm.ops.pll import pll_step

#: lanes per program: one warp, one lane per thread
LANE_TILE = 32
#: time steps per read-ahead tile
TILE_T = 16


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _kernel(x_ref, c0_ref, k_ref, args_ref, cout_ref, *, n_steps: int,
            tile_t: int):
    kp, ki, w, m = (k_ref[i, :] for i in range(4))
    carry = tuple(c0_ref[i, :] for i in range(4))

    def run_rows(c, rows, t0, count):
        for j in range(count):
            c, arg = pll_step(c, rows[j], kp, ki, w, m)
            args_ref[t0 + j, :] = arg
        return c

    def tile(i, val):
        c, rows = val
        t0 = i * tile_t
        ahead = tuple(x_ref[t0 + tile_t + j, :] for j in range(tile_t))
        return run_rows(c, rows, t0, tile_t), ahead

    n_full = n_steps // tile_t
    first = tuple(x_ref[j, :] for j in range(tile_t))
    carry, rows = lax.fori_loop(0, n_full, tile, (carry, first))
    carry = run_rows(carry, rows, n_full * tile_t, n_steps % tile_t)
    for i in range(4):
        cout_ref[i, :] = carry[i]


def pll_angles(xs: jnp.ndarray, carry0: tuple, consts: tuple, *,
               lane_tile: int = LANE_TILE, tile_t: int = TILE_T,
               interpret: bool = False) -> tuple[tuple, jnp.ndarray]:
    """Drop-in for ``lax.scan(pll_step, carry0, xs)``.

    ``xs``: time-major PLL input (T, ..., K); ``carry0``: the four carried
    loop values, each broadcastable to (..., K); ``consts``: (kp, ki, w,
    m), each broadcastable to (..., K).  Returns (final carry, angles of
    shape (T, ..., K)).  Runs only on a GPU unless ``interpret``, which
    runs the same kernel in the Pallas interpreter (CPU tests).
    """
    if not interpret and jax.default_backend() != "gpu":
        raise RuntimeError(
            "the PLL kernel runs on a GPU; pass interpret=True to run it "
            f"in the interpreter on {jax.default_backend()!r}")
    n_steps = xs.shape[0]
    lanes_shape = xs.shape[1:]
    n_lanes = 1
    for d in lanes_shape:
        n_lanes *= d
    lane_tile = min(lane_tile, pl.next_power_of_2(n_lanes))
    n_prog = _cdiv(n_lanes, lane_tile)
    l_pad = n_prog * lane_tile - n_lanes
    t_pad = (n_steps // tile_t + 1) * tile_t - n_steps

    def lanes(a):                      # (..., K) -> (L_pad,)
        flat = jnp.broadcast_to(a, lanes_shape).astype(jnp.float32)
        return jnp.pad(flat.reshape(n_lanes), (0, l_pad))

    x2 = jnp.pad(xs.astype(jnp.float32).reshape(n_steps, n_lanes),
                 ((0, t_pad), (0, l_pad)))
    c2 = jnp.stack([lanes(c) for c in carry0])
    k2 = jnp.stack([lanes(k) for k in consts])

    col = lambda rows: pl.BlockSpec((rows, lane_tile), lambda p: (0, p))
    args, cout = pl.pallas_call(
        functools.partial(_kernel, n_steps=n_steps, tile_t=tile_t),
        grid=(n_prog,),
        in_specs=[col(n_steps + t_pad), col(4), col(4)],
        out_specs=[col(n_steps), col(4)],
        out_shape=[
            jax.ShapeDtypeStruct((n_steps, n_lanes + l_pad), jnp.float32),
            jax.ShapeDtypeStruct((4, n_lanes + l_pad), jnp.float32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=max(1, lane_tile // 32), num_stages=1),
        interpret=interpret,
        name="pll_recurrence",
    )(x2, c2, k2)
    unlane = lambda a: a[..., :n_lanes].reshape(a.shape[:-1] + lanes_shape)
    carry = tuple(unlane(cout[i]) for i in range(4))
    return carry, unlane(args)
