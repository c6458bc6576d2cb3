"""The GPU PLL kernel (ops.pll_kernel) against the lax.scan recurrence.

On the CPU the kernel runs in the Pallas interpreter, where it executes
``ops.pll.pll_step`` — the scan's own body — so the two must agree BIT
for bit; on the GPU they are compared within a stated tolerance
(test_compiled_kernel_matches_scan, chip_smoke.py phase 5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sdr_fm import config as cfg
from sdr_fm.models import receiver as rx
from sdr_fm.ops import pll as jpll
from sdr_fm.ops import pll_kernel


def _params(mode: int, arms: str):
    mc = cfg.get_mode_config(mode)
    pilot, rds = rx.pilot_pll_params(mc), rx.rds_pll_params(mc)
    return {"pilot": (pilot,), "rds": (rds,), "pair": (pilot, rds)}[arms]


def _inputs(lead, params, n, seed, zeros):
    """Tone-plus-noise PLL inputs (..., K, n) near each arm's frequency."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / params[0].fs
    rows = [a * np.sin(2 * np.pi * (p.freq + rng.uniform(-30, 30)) * t
                       + rng.uniform(0, 6))
            for a, p in zip((0.4, 0.1), params)]
    x = np.broadcast_to(np.stack(rows), lead + (len(params), n))
    x = x + 0.05 * rng.standard_normal(x.shape)
    if zeros == "all":
        x = np.zeros_like(x)
    elif zeros == "some":
        x[..., ::7] = 0.0
    return jnp.asarray(x, jnp.float32)


def _state(lead, params):
    st = [jpll.pll_init(nco_q_last=1.0 if p.freq > 1e5 else 0.0)
          for p in params]
    return jax.tree.map(
        lambda *ls: jnp.broadcast_to(jnp.stack(ls, -1),
                                     lead + (len(params),)), *st)


# (mode, arms, lead batch, block length, blocks chained, zeros)
CASES = [
    (0, "pair", (), 300, 1, None),
    (0, "pilot", (3,), 300, 1, None),
    (1, "pair", (), 300, 1, None),
    (1, "pilot", (2,), 300, 1, None),
    (2, "pair", (), 300, 1, None),
    (2, "rds", (3,), 300, 1, None),
    (3, "pair", (), 300, 1, None),
    (3, "pilot", (2,), 300, 1, None),
    (0, "pilot", (), 200, 1, None),            # 1 lane
    (0, "pair", (), 200, 1, None),             # 2 lanes
    (0, "rds", (3,), 200, 1, None),            # 3 lanes
    (0, "pilot", (33,), 120, 1, None),         # 33 lanes: 2 programs
    (0, "pair", (512,), 64, 1, None),          # 1,024 lanes: 32 programs
    (0, "pair", (2,), 17, 1, None),            # T not a multiple of tile
    (0, "pair", (2,), 5, 1, None),             # T shorter than one tile
    (2, "pair", (3,), 1001, 1, None),          # long T with a remainder
    (0, "pair", (2,), 160, 1, "all"),          # x == 0 branch throughout
    (0, "pair", (2,), 160, 1, "some"),         # x == 0 mixed in
    (0, "pair", (3,), 150, 3, None),           # state chained over blocks
    (1, "pilot", (2,), 97, 4, "some"),         # chained, odd length
]


@pytest.mark.parametrize("mode,arms,lead,n,blocks,zeros", CASES)
def test_interpreted_kernel_bit_identical_to_scan(mode, arms, lead, n,
                                                  blocks, zeros):
    params = _params(mode, arms)
    x = _inputs(lead, params, n * blocks, seed=mode * 31 + n, zeros=zeros)
    sa = sb = _state(lead, params)
    for b in range(blocks):
        xb = x[..., b * n:(b + 1) * n]
        ia, qa, sa = jpll.pll_block_fused(xb, sa, params)
        ib, qb, sb = jpll.pll_block_fused(xb, sb, params, kernel=True,
                                          interpret=True)
        np.testing.assert_array_equal(np.asarray(ia), np.asarray(ib))
        np.testing.assert_array_equal(np.asarray(qa), np.asarray(qb))
    for f in sa._fields:
        np.testing.assert_array_equal(np.asarray(getattr(sa, f)),
                                      np.asarray(getattr(sb, f)), err_msg=f)


def test_single_arm_wrapper_matches_scan():
    """pll_block(kernel=True) == pll_block for an unbatched single PLL."""
    (p,) = _params(0, "pilot")
    x = _inputs((), (p,), 250, seed=3, zeros=None)[0]
    ia, qa, sa = jpll.pll_block(x, jpll.pll_init(), p)
    ib, qb, sb = jpll.pll_block(x, jpll.pll_init(), p, kernel=True,
                                interpret=True)
    np.testing.assert_array_equal(np.asarray(ia), np.asarray(ib))
    np.testing.assert_array_equal(np.asarray(sa.phase_est),
                                  np.asarray(sb.phase_est))


def test_kernel_refuses_cpu_without_interpret():
    """The compiled kernel exists only for the GPU: no silent fallback."""
    (p,) = _params(0, "pilot")
    x = jnp.zeros((64,), jnp.float32)
    with pytest.raises(RuntimeError, match="GPU"):
        jpll.pll_block(x, jpll.pll_init(), p, kernel=True)


@pytest.fixture
def interpreted_kernel(monkeypatch):
    """Route the receiver's kernel calls through the interpreter."""
    real = pll_kernel.pll_angles
    monkeypatch.setattr(pll_kernel, "pll_angles",
                        lambda *a, **k: real(*a, **{**k, "interpret": True}))


@pytest.mark.parametrize("mode,stereo,with_rds", [
    (0, True, True),          # fused pilot + RDS pair
    (1, True, False),         # pilot alone
    (0, False, True),         # RDS carrier alone
])
def test_receiver_block_kernel_on_off(interpreted_kernel, mode, stereo,
                                      with_rds):
    """The whole block DAG with the kernel on equals it with the kernel
    off, bit for bit, across two chained blocks."""
    mc = cfg.get_mode_config(mode)
    bs = mc.default_block_size(with_rds)
    coeffs = rx.design_coeffs(mc)
    rng = np.random.default_rng(mode)
    iq = rng.integers(0, 256, 2 * bs, dtype=np.uint8)
    sa = sb = rx.init_state(mc)
    for b in range(2):
        blk = jnp.asarray(iq[b * bs:(b + 1) * bs])
        oa, sa = rx.process_block(blk, coeffs, sa, mc, stereo=stereo,
                                  with_rds=with_rds)
        ob, sb = rx.process_block(blk, coeffs, sb, mc, stereo=stereo,
                                  with_rds=with_rds, pll_kernel=True)
        for f in oa._fields:
            np.testing.assert_array_equal(np.asarray(getattr(oa, f)),
                                          np.asarray(getattr(ob, f)),
                                          err_msg=f)


@pytest.mark.gpu
def test_compiled_kernel_matches_scan(gpu):
    """On the GPU: 1,024 lanes over 4 chained mode-0 blocks.  The kernel
    runs the scan's own step, so only FMA contraction can move the last
    bits of a phase: 1e-4 on the unit-amplitude NCO."""
    params = _params(0, "pair")
    n = 5760
    x = _inputs((512,), params, 4 * n, seed=1, zeros="some")
    sa = sb = _state((512,), params)
    for b in range(4):
        xb = x[..., b * n:(b + 1) * n]
        ia, _, sa = jpll.pll_block_fused(xb, sa, params)
        ib, _, sb = jpll.pll_block_fused(xb, sb, params, kernel=True)
        np.testing.assert_allclose(np.asarray(ia), np.asarray(ib),
                                   atol=1e-4, rtol=0)
