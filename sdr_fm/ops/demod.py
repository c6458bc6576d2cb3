"""Vectorized FM discriminators (pure elementwise ops).

The reference's per-sample loops (src/filter.cpp:248-266 ``fmDemod``;
model/fmSupportLib.py:466-531) become shifted-array arithmetic: the only
cross-sample dependency is a one-sample delay, carried as a 2-element state.
"""

from __future__ import annotations

import jax.numpy as jnp


def fm_demod_quad(i: jnp.ndarray, q: jnp.ndarray, prev_iq: jnp.ndarray
                  ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Derivative discriminator (I*dQ - Q*dI)/(I^2+Q^2); zero-power -> 0
    (ref: src/filter.cpp:248-266).  Supports leading batch dims."""
    ip = jnp.concatenate([prev_iq[..., 0:1], i[..., :-1]], axis=-1)
    qp = jnp.concatenate([prev_iq[..., 1:2], q[..., :-1]], axis=-1)
    num = i * (q - qp) - q * (i - ip)
    den = i * i + q * q
    y = jnp.where(den == 0.0, 0.0, num / jnp.where(den == 0.0, 1.0, den))
    new_prev = jnp.stack([i[..., -1], q[..., -1]], axis=-1)
    return y, new_prev


def fm_demod_arctan(i: jnp.ndarray, q: jnp.ndarray, prev_phase: jnp.ndarray
                    ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """atan2 discriminator with wrap-to-(-pi,pi] phase differencing
    (ref: model/fmSupportLib.py:502-531).

    Equivalent to unwrap-then-diff: each output is the wrapped difference of
    consecutive instantaneous phases.
    """
    phase = jnp.arctan2(q, i)
    prev = jnp.concatenate([prev_phase[..., None], phase[..., :-1]], axis=-1)
    d = phase - prev
    y = jnp.mod(d + jnp.pi, 2 * jnp.pi) - jnp.pi
    return y, phase[..., -1]
