"""PLL + NCO as a lax.scan recurrence.

Reference: fmPll (model/fmSupportLib.py:297-353, src/filter.cpp:32-80) — a
second-order type-2 PLL whose per-sample recurrence is inherently
sequential (SURVEY.md "hard parts" #1).  It runs as ``lax.scan`` (XLA
compiles the body once and loops on-device) or, on the GPU, as one
kernel (ops.pll_kernel) running the same step function.

Numerical design choice vs the reference: the reference accumulates
``trigOffset`` (sample count) and ``phaseEst`` without bound and evaluates
``cos(2*pi*f/fs*trigOffset + phaseEst)`` — in float32 that loses phase
precision after ~1e7 samples.  We carry the oscillator phase and phase
estimate *wrapped* modulo ``2*pi*q`` where ``q`` is the smallest integer
making ``q * nco_scale`` integral, which leaves every emitted cos/sin (both
the x1 feedback and the x``nco_scale`` output tap) bit-identical in exact
arithmetic while keeping the carried phase O(1).  State layout therefore
differs from the reference's 7-vector but carries the same information.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

# Loop-filter constants for damping 1/sqrt(2) (model/fmSupportLib.py:303-309).
_CP = 2.666
_CI = 3.555


class PllParams(NamedTuple):
    freq: float
    fs: float
    nco_scale: float = 2.0
    phase_adjust: float = 0.0
    norm_bandwidth: float = 0.01

    @property
    def wrap_modulus(self) -> float:
        q = 1
        while (q * self.nco_scale) % 1.0 != 0.0:
            q += 1
            if q > 64:
                raise ValueError(f"nco_scale {self.nco_scale} not rational "
                                 "with small denominator")
        return 2.0 * jnp.pi * q


class PllState(NamedTuple):
    integrator: jnp.ndarray
    phase_est: jnp.ndarray   # wrapped mod M
    osc_phase: jnp.ndarray   # wrapped 2*pi*f/fs * trigOffset, mod M
    feedback_i: jnp.ndarray
    feedback_q: jnp.ndarray
    nco_last: jnp.ndarray
    nco_q_last: jnp.ndarray


def pll_init(nco_last: float = 1.0, nco_q_last: float = 0.0,
             dtype=jnp.float32) -> PllState:
    """Initial state matching the reference's [0,0,1,0,1,0,(q0)]
    (model/stereo.py:135, model/fmRDS.py:173)."""
    f = lambda v: jnp.asarray(v, dtype=dtype)
    return PllState(f(0.0), f(0.0), f(0.0), f(1.0), f(0.0),
                    f(nco_last), f(nco_q_last))


_PI = float(np.pi)


def wrap_pi(a):
    """Wrap an angle into [-pi, pi)."""
    two_pi = 2.0 * _PI
    return a - two_pi * jnp.floor(a / two_pi + 0.5)


def pll_step(carry, xk, kp, ki, w, m):
    """One transcendental-free PLL step (see ``pll_block``).

    ``carry`` is (integrator, phase_est, osc_phase, wrapped feedback
    angle); returns (new carry, oscillator angle).  Shared by the
    ``lax.scan`` recurrence below and the GPU kernel
    (ops.pll_kernel), so both run the same arithmetic.
    """
    integ, phase, psi, aw = carry
    err_pos = -aw
    err_neg = jnp.where(aw > 0, _PI - aw, -_PI - aw)
    err_zero = jnp.where(jnp.abs(aw) < _PI / 2, 0.0,
                         jnp.where(aw > 0, -_PI, _PI))
    err = jnp.where(xk > 0, err_pos,
                    jnp.where(xk < 0, err_neg, err_zero))
    integ = integ + ki * err
    phase = jnp.mod(phase + kp * err + integ, m)
    psi = jnp.mod(psi + w, m)
    arg = psi + phase
    return (integ, phase, psi, wrap_pi(arg)), arg


def _pll_recurrence(xs, state, kp, ki, w, m, unroll, kernel, interpret):
    """The sequential part of the PLL over time-major ``xs`` (N, ..., K).

    The loop constants may be scalars or arrays broadcastable against the
    carried state — array constants let several *different* PLLs (e.g.
    the 19 kHz pilot and the 114 kHz RDS carrier) share ONE recurrence
    (see ``pll_block_fused``).  ``kernel`` runs it as the GPU kernel
    (ops.pll_kernel) instead of ``lax.scan``.  Returns (final carry,
    oscillator angles (N, ..., K)).
    """
    # recover the carried feedback angle (wrapped is all err needs)
    aw0 = jnp.arctan2(state.feedback_q, state.feedback_i)
    carry0 = (state.integrator, state.phase_est, state.osc_phase, aw0)
    if kernel:
        from sdr_fm.ops import pll_kernel
        return pll_kernel.pll_angles(xs, carry0, (kp, ki, w, m),
                                     interpret=interpret)
    return lax.scan(lambda c, xk: pll_step(c, xk, kp, ki, w, m),
                    carry0, xs, unroll=unroll)


def _finish(args, carry, state, scale, adj):
    """NCO outputs and the new state from the oscillator angles.

    All trig is vectorized over the block, outside the recurrence.
    Returns (nco_i, nco_q, new_state) with the reference's N+1 layout."""
    outs_i = jnp.moveaxis(jnp.cos(args * scale + adj), 0, -1)
    outs_q = jnp.moveaxis(jnp.sin(args * scale + adj), 0, -1)
    nco_i = jnp.concatenate([state.nco_last[..., None], outs_i], axis=-1)
    nco_q = jnp.concatenate([state.nco_q_last[..., None], outs_q], axis=-1)
    new_state = PllState(carry[0], carry[1], carry[2], jnp.cos(carry[3]),
                         jnp.sin(carry[3]), nco_i[..., -1], nco_q[..., -1])
    return nco_i, nco_q, new_state


def pll_block(x: jnp.ndarray, state: PllState, params: PllParams,
              use_atan2: bool = False, unroll: int = 32,
              kernel: bool = False, interpret: bool = False
              ) -> tuple[jnp.ndarray, jnp.ndarray, PllState]:
    """Run the PLL over one block.

    Returns (nco_i, nco_q, new_state); the NCO arrays have ``len(x)+1``
    entries with index 0 the carried previous output, so downstream mixers
    use ``nco[:-1]`` exactly like the reference (model/stereo.py:226).

    ``x`` may carry leading batch dims (..., N) — e.g. a channel batch — in
    which case every state leaf has shape (...) and the recurrence runs
    all channels in lockstep (the recurrences are independent, so the
    batch vectorizes).

    **Transcendental-free recurrence** (the default): because the PLL input
    is real, the reference's phase detector
    ``atan2(x*(-sin a), x*cos a)`` (src/filter.cpp:52-57) is exactly

        x > 0:  wrap_pi(-a)
        x < 0:  wrap_pi(pi - a)
        x == 0: 0 if cos a > 0 else -sign(sin a)*pi   (IEEE atan2 of +-0)

    so the sequential loop needs only adds/compares/selects, and every
    cos/sin moves OUT of the loop into one vectorized pass over the block
    (SURVEY.md "hard parts" #1).  ``use_atan2=True`` keeps the literal
    reference recurrence for A/B validation.  ``kernel`` runs the loop as
    the GPU kernel of ops.pll_kernel (``interpret`` for its CPU
    interpreter).
    """
    if use_atan2:
        return _pll_block_atan2(x, state, params, unroll)
    st1 = jax.tree.map(lambda l: l[..., None], state)
    i1, q1, st1 = pll_block_fused(x[..., None, :], st1, (params,),
                                  unroll=unroll, kernel=kernel,
                                  interpret=interpret)
    return (i1[..., 0, :], q1[..., 0, :],
            jax.tree.map(lambda l: l[..., 0], st1))


def _pll_block_atan2(x, state, params, unroll):
    """The literal reference recurrence (atan2 detector, trig in-loop)."""
    kp = params.norm_bandwidth * _CP
    ki = params.norm_bandwidth * params.norm_bandwidth * _CI
    w = 2.0 * jnp.pi * params.freq / params.fs
    m = params.wrap_modulus
    scale = params.nco_scale
    adj = params.phase_adjust

    def step(carry, xk):
        integ, phase, psi, fb_i, fb_q = carry
        err = jnp.arctan2(xk * (-fb_q), xk * fb_i)
        integ = integ + ki * err
        phase = jnp.mod(phase + kp * err + integ, m)
        psi = jnp.mod(psi + w, m)
        arg = psi + phase
        fb_i = jnp.cos(arg)
        fb_q = jnp.sin(arg)
        out_i = jnp.cos(arg * scale + adj)
        out_q = jnp.sin(arg * scale + adj)
        return (integ, phase, psi, fb_i, fb_q), (out_i, out_q)

    carry0 = (state.integrator, state.phase_est, state.osc_phase,
              state.feedback_i, state.feedback_q)
    carry, (outs_i, outs_q) = lax.scan(step, carry0, jnp.moveaxis(x, -1, 0),
                                       unroll=unroll)
    nco_i = jnp.concatenate([state.nco_last[..., None],
                             jnp.moveaxis(outs_i, 0, -1)], axis=-1)
    nco_q = jnp.concatenate([state.nco_q_last[..., None],
                             jnp.moveaxis(outs_q, 0, -1)], axis=-1)
    return nco_i, nco_q, PllState(carry[0], carry[1], carry[2], carry[3],
                                  carry[4], nco_i[..., -1], nco_q[..., -1])


def pll_block_fused(x: jnp.ndarray, state: PllState,
                    params_seq: tuple[PllParams, ...],
                    unroll: int = 32, kernel: bool = False,
                    interpret: bool = False
                    ) -> tuple[jnp.ndarray, jnp.ndarray, PllState]:
    """Run K *different* PLLs in lockstep through ONE recurrence.

    ``x`` has shape (..., K, N) with row k driven by ``params_seq[k]``;
    every ``state`` leaf has shape (..., K).  The per-sample math is
    elementwise-identical to K separate ``pll_block`` calls (the loop
    constants just become length-K vectors), so outputs are bit-identical
    — but the receiver's sequential bottleneck (SURVEY.md "hard parts"
    #1) runs once instead of K times.  Used by the stereo+RDS DAG to fuse
    the 19 kHz pilot PLL (src/project.cpp:237) and the 114 kHz RDS
    carrier PLL (model/fmRDS.py:236-237) into a single recurrence.
    """
    k = len(params_seq)
    assert x.shape[-2] == k, (x.shape, k)
    vec = lambda vals: jnp.asarray(vals, dtype=x.dtype)
    kp = vec([p.norm_bandwidth * _CP for p in params_seq])
    ki = vec([p.norm_bandwidth ** 2 * _CI for p in params_seq])
    w = vec([2.0 * np.pi * p.freq / p.fs for p in params_seq])
    m = vec([p.wrap_modulus for p in params_seq])
    scale = vec([p.nco_scale for p in params_seq])
    adj = vec([p.phase_adjust for p in params_seq])

    xs = jnp.moveaxis(x, -1, 0)  # (N, ..., K): loop over time, vectorize K
    carry, args = _pll_recurrence(xs, state, kp, ki, w, m, unroll, kernel,
                                  interpret)
    return _finish(args, carry, state, scale, adj)
