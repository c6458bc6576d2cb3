"""JAX ops vs golden oracle — block-by-block tolerance equivalence.

This is the rebuild's version of the reference's "bit equivalence between
the C++ refactor and the Python model" requirement (SURVEY.md section 4):
every JAX primitive must match the numpy golden implementation within
float32 tolerance, streaming state included.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sdr_fm.golden import demod as gdemod
from sdr_fm.golden import filters as gfilt
from sdr_fm.golden import pll as gpll
from sdr_fm.golden import spectrum as gspec
from sdr_fm.ops import demod as jdemod
from sdr_fm.ops import fir as jfir
from sdr_fm.ops import pll as jpll
from sdr_fm.ops import spectrum as jspec


def _f32(x):
    return jnp.asarray(x, dtype=jnp.float32)


class TestFir:
    def test_block_fir_matches_golden(self, rng):
        h = gfilt.lowpass_taps(151, 2.4e6, 100e3)
        x = rng.normal(size=2000)
        gy, gs = gfilt.block_fir(x, h, np.zeros(150))
        jy, js = jfir.fir_block(_f32(x), _f32(h), _f32(np.zeros(150)))
        np.testing.assert_allclose(jy, gy, atol=1e-5)
        np.testing.assert_allclose(js, gs, atol=1e-6)

    def test_decim_stream_matches_golden(self, rng):
        h = gfilt.lowpass_taps(151, 2.4e6, 100e3)
        x = rng.normal(size=8000)
        gs = np.zeros(150)
        js = _f32(gs)
        for b in range(4):
            blk = x[b * 2000:(b + 1) * 2000]
            gy, gs = gfilt.block_fir_decim(blk, h, gs, 10)
            jy, js = jfir.fir_block_decim(_f32(blk), _f32(h), js, 10)
            np.testing.assert_allclose(jy, gy, atol=1e-5)

    @pytest.mark.parametrize("use_conv", [False, True])
    @pytest.mark.parametrize("u,d,taps_mult", [(3, 4, 11), (147, 800, 101),
                                               (247, 960, 101)])
    def test_resample_matches_golden(self, rng, u, d, taps_mult, use_conv):
        taps = taps_mult * u
        h = gfilt.lowpass_taps(taps, 240e3 * u, 3e3)
        n = d * 12 // np.gcd(d, u)  # an even multiple for clean blocks
        x = rng.normal(size=2 * n)
        gs = np.zeros(gfilt.resample_state_len(taps, u))
        js = _f32(gs)
        for b in range(2):
            blk = x[b * n:(b + 1) * n]
            gy, gs = gfilt.block_fir_resample(blk, h, gs, d, u)
            jy, js = jfir.fir_block_resample(_f32(blk), _f32(h), js, d, u,
                                             use_conv=use_conv)
            np.testing.assert_allclose(jy, gy, atol=2e-4)
            np.testing.assert_allclose(js, gs, atol=1e-6)

    def test_resampler_property_sweep(self, rng):
        """Randomized (U, D, taps, block) sweep vs the golden polyphase —
        the reference's hardest-won correctness area (index-trace
        validation, src/testing.cpp:202-252)."""
        prng = np.random.default_rng(7)
        for _ in range(12):
            u = int(prng.integers(1, 13))
            d = int(prng.integers(1, 13))
            t_per = int(prng.integers(2, 9))
            taps = t_per * u + int(prng.integers(0, u))  # any taps >= U
            n = int(d * prng.integers(4, 9))
            x = rng.normal(size=2 * n)
            gs = np.zeros(gfilt.resample_state_len(taps, u))
            js = _f32(gs)
            h = rng.normal(size=taps) / taps
            for b in range(2):
                blk = x[b * n:(b + 1) * n]
                gy, gs = gfilt.block_fir_resample(blk, h, gs, d, u)
                jy, js = jfir.fir_block_resample(_f32(blk), _f32(h), js,
                                                 d, u)
                np.testing.assert_allclose(
                    jy, gy, atol=1e-5,
                    err_msg=f"U={u} D={d} taps={taps} n={n} block={b}")

    def test_allpass_matches_golden(self, rng):
        x = rng.normal(size=500)
        gy, gs = gfilt.allpass_delay(x, np.zeros(75))
        jy, js = jfir.allpass_delay(_f32(x), _f32(np.zeros(75)))
        np.testing.assert_allclose(jy, gy, atol=1e-7)
        np.testing.assert_allclose(js, gs, atol=1e-7)

    def test_batched_fir(self, rng):
        """Leading batch dims (channel-parallel) give per-row identical results."""
        h = gfilt.lowpass_taps(31, 10.0, 1.0)
        xs = rng.normal(size=(4, 512))
        states = np.zeros((4, 30))
        jy, js = jfir.fir_block_decim(_f32(xs), _f32(h), _f32(states), 2)
        for r in range(4):
            gy, _ = gfilt.block_fir_decim(xs[r], h, np.zeros(30), 2)
            np.testing.assert_allclose(jy[r], gy, atol=1e-5)


class TestDemod:
    def test_quad_matches_golden(self, rng):
        i = rng.normal(size=1000) + 2.0
        q = rng.normal(size=1000)
        gy, gs = gdemod.fm_demod_quad(i, q, np.zeros(2))
        jy, js = jdemod.fm_demod_quad(_f32(i), _f32(q), _f32(np.zeros(2)))
        np.testing.assert_allclose(jy, gy, atol=1e-5)
        np.testing.assert_allclose(js, gs, atol=1e-6)

    def test_arctan_matches_golden(self, rng):
        fs = 240e3
        t = np.arange(3000) / fs
        phase = 2 * np.pi * 30e3 * np.cumsum(
            np.sin(2 * np.pi * 700 * t)) / fs
        i, q = np.cos(phase), np.sin(phase)
        gy, _ = gdemod.fm_demod_arctan(i, q, 0.0)
        jy, _ = jdemod.fm_demod_arctan(_f32(i), _f32(q), _f32(0.0))
        np.testing.assert_allclose(jy, gy, atol=1e-4)


class TestPll:
    @pytest.mark.parametrize("nco_scale,adj,bw,f", [
        (2.0, 0.0, 0.01, 19e3),
        (0.5, 3 * np.pi / 8, 0.002, 114e3),
    ])
    def test_matches_golden_streaming(self, nco_scale, adj, bw, f):
        fs = 240e3
        t = np.arange(6000) / fs
        x = 0.4 * np.sin(2 * np.pi * (f + 25) * t + 0.3)
        params = jpll.PllParams(freq=f, fs=fs, nco_scale=nco_scale,
                                phase_adjust=adj, norm_bandwidth=bw)
        gst = gpll.PllState(nco_q_last=0.0)
        jst = jpll.pll_init(nco_q_last=0.0)
        for b in range(3):
            blk = x[b * 2000:(b + 1) * 2000]
            gi, gq, gst = gpll.fm_pll(blk, f, fs, gst, nco_scale=nco_scale,
                                      phase_adjust=adj, norm_bandwidth=bw)
            ji, jq, jst = jpll.pll_block(_f32(blk), jst, params)
            # float32 atan2/cos chains accumulate roundoff through the
            # recurrence; require close agreement, not bit equality
            np.testing.assert_allclose(ji, gi, atol=2e-2)
            np.testing.assert_allclose(jq, gq, atol=2e-2)

    def test_transcendental_free_equals_atan2_variant(self):
        """The wrapped-phase detector must track the literal atan2
        recurrence sample-for-sample (same math, different evaluation)."""
        fs = 240e3
        t = np.arange(4000) / fs
        x = (0.4 * np.sin(2 * np.pi * 19020 * t + 0.3)
             + 0.01 * np.sin(2 * np.pi * 700 * t))
        params = jpll.PllParams(freq=19e3, fs=fs, nco_scale=2.0)
        sa = jpll.pll_init(nco_q_last=0.0)
        sb = jpll.pll_init(nco_q_last=0.0)
        for b in range(2):
            blk = _f32(x[b * 2000:(b + 1) * 2000])
            ia, qa, sa = jpll.pll_block(blk, sa, params, use_atan2=True)
            ib, qb, sb = jpll.pll_block(blk, sb, params, use_atan2=False)
            np.testing.assert_allclose(ia, ib, atol=5e-3)
            np.testing.assert_allclose(qa, qb, atol=5e-3)

    def test_batched_matches_per_row(self):
        """Leading batch dims (channel-parallel) run lockstep scans whose
        per-row outputs equal independent single-channel runs."""
        fs = 240e3
        t = np.arange(1500) / fs
        xs = np.stack([0.4 * np.sin(2 * np.pi * (19e3 + df) * t + ph)
                       for df, ph in [(10, 0.0), (-40, 1.0), (25, 2.0)]])
        params = jpll.PllParams(freq=19e3, fs=fs, nco_scale=2.0)
        bst = jax.tree.map(lambda l: jnp.broadcast_to(l, (3,)), jpll.pll_init())
        bi, bq, bst2 = jpll.pll_block(_f32(xs), bst, params)
        assert bi.shape == (3, 1501) and bst2.phase_est.shape == (3,)
        for r in range(3):
            si, sq, _ = jpll.pll_block(_f32(xs[r]), jpll.pll_init(), params)
            np.testing.assert_allclose(bi[r], si, atol=1e-5)
            np.testing.assert_allclose(bq[r], sq, atol=1e-5)

    @pytest.mark.parametrize("df", [-80.0, -25.0, 0.0, 25.0, 80.0])
    def test_lock_capture_range(self, df):
        """The pilot PLL must lock across realistic frequency offsets
        (crystal tolerance); after lock the doubled NCO tracks 2x the
        actual pilot frequency."""
        fs = 240e3
        n = 24000
        t = np.arange(n) / fs
        x = 0.35 * np.sin(2 * np.pi * (19e3 + df) * t + 1.1)
        params = jpll.PllParams(freq=19e3, fs=fs, nco_scale=2.0)
        ji, _, _ = jpll.pll_block(_f32(x), jpll.pll_init(nco_q_last=0.0),
                                  params)
        tail = np.asarray(ji)[-8000:]
        xf = np.abs(np.fft.rfft(tail * np.hanning(len(tail))))
        peak = np.fft.rfftfreq(len(tail), 1 / fs)[np.argmax(xf[10:]) + 10]
        assert abs(peak - 2 * (19e3 + df)) < 60.0, (peak, df)

    def test_fused_pair_bit_identical_to_separate(self):
        """pll_block_fused(pilot, rds_carrier) must reproduce the two
        independent pll_block runs bit-for-bit — the fusion only turns
        the loop constants into length-2 vectors (same elementwise ops),
        so any difference is a bug.  Streams 3 blocks to cover the
        carried state too."""
        fs = 240e3
        p_pilot = jpll.PllParams(freq=19e3, fs=fs, nco_scale=2.0,
                                 norm_bandwidth=0.01)
        p_rds = jpll.PllParams(freq=114e3, fs=fs, nco_scale=0.5,
                               phase_adjust=3 * np.pi / 8,
                               norm_bandwidth=0.002)
        rng = np.random.default_rng(7)
        t = np.arange(6000) / fs
        xp = 0.4 * np.sin(2 * np.pi * 19010 * t + 0.2)
        xr = 0.1 * np.sin(2 * np.pi * 113985 * t + 1.7)
        xp += 0.02 * rng.standard_normal(6000)
        xr += 0.02 * rng.standard_normal(6000)

        sp, sr = jpll.pll_init(), jpll.pll_init(nco_q_last=1.0)
        sf = jax.tree.map(lambda a, b: jnp.stack([a, b], axis=-1), sp, sr)
        for b in range(3):
            bp = _f32(xp[b * 2000:(b + 1) * 2000])
            br = _f32(xr[b * 2000:(b + 1) * 2000])
            ip, qp, sp = jpll.pll_block(bp, sp, p_pilot)
            ir, qr, sr = jpll.pll_block(br, sr, p_rds)
            fi, fq, sf = jpll.pll_block_fused(
                jnp.stack([bp, br], axis=-2), sf, (p_pilot, p_rds))
            np.testing.assert_array_equal(np.asarray(fi[0]), np.asarray(ip))
            np.testing.assert_array_equal(np.asarray(fi[1]), np.asarray(ir))
            np.testing.assert_array_equal(np.asarray(fq[0]), np.asarray(qp))
            np.testing.assert_array_equal(np.asarray(fq[1]), np.asarray(qr))

    def test_wrap_modulus(self):
        assert jpll.PllParams(19e3, 240e3, 2.0).wrap_modulus == pytest.approx(
            2 * np.pi)
        assert jpll.PllParams(114e3, 240e3, 0.5).wrap_modulus == pytest.approx(
            4 * np.pi)


class TestSpectrum:
    def test_dft_matches_golden(self, rng):
        x = rng.normal(size=64)
        gy = gspec.dft(x)
        jy = jspec.dft_matmul(_f32(x))
        np.testing.assert_allclose(np.asarray(jy), gy, atol=1e-3)

    def test_dft_idft_roundtrip(self, rng):
        """DFT -> IDFT inverse property (ref: test/idft_unittest.cpp:50-60)."""
        x = rng.normal(size=128).astype(np.float32)
        back = jspec.idft_matmul(jspec.dft_matmul(jnp.asarray(x)))
        np.testing.assert_allclose(np.real(back), x, atol=1e-3)

    def test_psd_matmul_dft_matches_fft_path(self, rng):
        fs = 240e3
        x = (np.sin(2 * np.pi * 57e3 * np.arange(4096) / fs)
             + 0.05 * rng.normal(size=4096)).astype(np.float32)
        _, p_fft = jspec.estimate_psd(_f32(x), 512, fs)
        _, p_mm = jspec.estimate_psd(_f32(x), 512, fs, use_matmul_dft=True)
        np.testing.assert_allclose(np.asarray(p_mm), np.asarray(p_fft),
                                   atol=1e-2)

    def test_psd_matches_golden(self, rng):
        fs = 240e3
        t = np.arange(8192) / fs
        x = np.sin(2 * np.pi * 19e3 * t) + 0.01 * rng.normal(size=8192)
        gf, gp = gspec.estimate_psd(x, 512, fs)
        jf, jp = jspec.estimate_psd(_f32(x), 512, fs)
        np.testing.assert_allclose(jf, gf)
        np.testing.assert_allclose(np.asarray(jp), gp, atol=0.1)
        # peak bin at 19 kHz
        assert abs(gf[np.argmax(gp)] - 19e3) < fs / 512


class TestMxuFir:
    """Banded-matmul FIR kernels (ops.fir.*_mm, DESIGN.md §2) vs their
    conv/gather siblings: same math, different formulation.  States must
    be EXACTLY equal (they are input slices); outputs within f32
    accumulation noise.  These kernels are the GPU default (receiver
    mxu_fir)."""

    def test_split_bf16_keeps_16_bits(self, rng):
        """hi is exactly bf16, hi + lo carries ~16 mantissa bits, and lo
        survives under jit with the weights as a runtime argument."""
        w = _f32(rng.normal(size=4096) * 10.0 ** rng.uniform(-6, 0, 4096))
        hi, lo = jax.jit(jfir.split_bf16)(w)
        assert hi.dtype == lo.dtype == jnp.bfloat16
        w64 = np.asarray(w, np.float64)
        hi64 = np.asarray(hi.astype(jnp.float32), np.float64)
        lo64 = np.asarray(lo.astype(jnp.float32), np.float64)
        assert np.all(np.abs(w64 - hi64) <= np.abs(w64) * 2.0 ** -8)
        assert np.count_nonzero(lo64) > 0.9 * w.size
        assert np.all(np.abs(w64 - hi64 - lo64) <= np.abs(w64) * 2.0 ** -16)

    @pytest.mark.parametrize("n,k,d,batch", [
        (5760, 151, 10, ()),          # mode-0 RF shape
        (5760, 151, 10, (3,)),        # channel batch
        (5760, 101, 5, (2, 2)),       # mode-0 audio decim, 2D batch
        (640, 13, 10, ()),            # short taps
        (1278, 7, 2, ()),             # n_out not a multiple of u_blk
    ])
    def test_decim_matches_conv(self, rng, n, k, d, batch):
        h = _f32(rng.normal(size=k))
        x = _f32(rng.normal(size=batch + (n,)))
        st = _f32(rng.normal(size=batch + (k - 1,)))
        y0, s0 = jfir.fir_block_decim(x, h, st, d)
        y1, s1 = jfir.fir_block_decim_mm(x, h, st, d)
        np.testing.assert_allclose(np.asarray(y1), np.asarray(y0),
                                   atol=5e-4)
        np.testing.assert_array_equal(np.asarray(s1), np.asarray(s0))

    def test_interleaved_bit_identical_to_mm(self, rng):
        """The RF-front-end variant gathers from the interleaved signal;
        same W and summation order -> bit-identical to the plain mm on
        the deinterleaved input."""
        n, k, d = 5760, 151, 10
        h = _f32(rng.normal(size=k))
        x_int = _f32(rng.normal(size=(3, 2 * n)))
        st2 = _f32(rng.normal(size=(3, 2, k - 1)))
        iq2 = jnp.stack([x_int[..., 0::2], x_int[..., 1::2]], axis=-2)
        y0, s0 = jfir.fir_block_decim_mm(iq2, h, st2, d)
        y1, s1 = jfir.fir_block_decim_mm_interleaved(x_int, h, st2, d)
        np.testing.assert_array_equal(np.asarray(y1), np.asarray(y0))
        np.testing.assert_array_equal(np.asarray(s1), np.asarray(s0))

    def test_interleaved_streaming_invariance(self, rng):
        """Chained interleaved-mm blocks == one big interleaved-mm block."""
        n, k, d = 1920, 151, 10
        h = _f32(rng.normal(size=k))
        x = _f32(rng.normal(size=(4 * 2 * n,)))
        st = jnp.zeros((2, k - 1), jnp.float32)
        one, _ = jfir.fir_block_decim_mm_interleaved(x, h, st, d)
        st2 = jnp.zeros((2, k - 1), jnp.float32)
        parts = []
        for b in range(4):
            y, st2 = jfir.fir_block_decim_mm_interleaved(
                x[b * 2 * n:(b + 1) * 2 * n], h, st2, d)
            parts.append(np.asarray(y))
        # chained and whole-capture runs tile different window counts, so
        # the matmul summation orders differ: f32-noise equal, not bit
        np.testing.assert_allclose(np.concatenate(parts, -1),
                                   np.asarray(one), atol=5e-5)

    def test_bf16_u8_normalize_is_exact(self, rng):
        """(u8 - 128)/128 in bfloat16 is bit-identical to the f32
        normalization: an 8-bit signed integer times 2^-7 fits bf16's
        8 mantissa bits exactly.  This is the premise of the bf16x
        front-end (ops.fir.fir_block_decim_mm_bf16x)."""
        u8 = jnp.asarray(rng.integers(0, 256, size=4096, dtype=np.uint8))
        f32 = (u8.astype(jnp.float32) - 128.0) * jnp.float32(1.0 / 128.0)
        bf = ((u8.astype(jnp.bfloat16) - jnp.bfloat16(128.0))
              * jnp.bfloat16(1.0 / 128.0))
        np.testing.assert_array_equal(np.asarray(bf.astype(jnp.float32)),
                                      np.asarray(f32))

    def test_bf16x_matches_f32_mm_on_u8_input(self, rng):
        """Weight-split bf16 kernel vs the f32 HIGH kernel on u8-normalized
        input: x side exact, W split to ~2^-17 — tighter than HIGH's
        1.5e-5.  State tail must round-trip the f32 pytree losslessly."""
        n, k, d = 5760, 151, 10
        h = _f32(rng.normal(size=k) * 0.05)
        u8 = rng.integers(0, 256, size=(3, n), dtype=np.uint8)
        x32 = (jnp.asarray(u8).astype(jnp.float32) - 128.0) / 128.0
        xbf = ((jnp.asarray(u8).astype(jnp.bfloat16) - jnp.bfloat16(128.0))
               * jnp.bfloat16(1.0 / 128.0))
        st32 = jnp.zeros((3, k - 1), jnp.float32)
        y0, s0 = jfir.fir_block_decim_mm(x32, h, st32, d)
        y1, s1 = jfir.fir_block_decim_mm_bf16x(
            xbf, h, st32.astype(jnp.bfloat16), d)
        ref = np.abs(np.asarray(y0)).max()
        np.testing.assert_allclose(np.asarray(y1), np.asarray(y0),
                                   atol=max(1e-6, 5e-5 * ref))
        np.testing.assert_array_equal(
            np.asarray(s1.astype(jnp.float32)), np.asarray(s0))

    def test_receiver_u8_bf16_frontend_matches_f32_mxu(self):
        """Full mode-0 stereo+RDS block: raw-u8 mxu DAG (bf16 front-end)
        vs the same DAG fed pre-normalized f32 (f32 HIGH front-end)."""
        from sdr_fm import config as cfg
        from sdr_fm.models import receiver as rx
        from sdr_fm.utils import synth
        mc = cfg.get_mode_config(0)
        bs = mc.default_block_size(True)
        res = synth.synthesize_fm(duration_s=0.15, mode=0, with_rds=True,
                                  seed=3)
        raw = jnp.asarray(res.iq_u8[:bs])
        coeffs = rx.design_coeffs(mc)
        o1, _ = rx.process_block(raw, coeffs, rx.init_state(mc), mc,
                                 stereo=True, with_rds=True, mxu_fir=True)
        o0, _ = rx.process_block(synth.u8_to_float(res.iq_u8[:bs]), coeffs,
                                 rx.init_state(mc), mc, stereo=True,
                                 with_rds=True, mxu_fir=True)
        for a in ("left", "right", "mono", "rds_symbols", "fm_demod"):
            np.testing.assert_allclose(
                np.asarray(getattr(o1, a)), np.asarray(getattr(o0, a)),
                atol=1e-4, err_msg=a)

    def test_multi_matches_conv(self, rng):
        hs = _f32(rng.normal(size=(3, 151)))
        x = _f32(rng.normal(size=(4, 5760)))
        st = _f32(rng.normal(size=(4, 150)))
        y0, s0 = jfir.fir_block_multi(x, hs, st)
        y1, s1 = jfir.fir_block_multi_mm(x, hs, st)
        np.testing.assert_allclose(np.asarray(y1), np.asarray(y0),
                                   atol=5e-4)
        np.testing.assert_array_equal(np.asarray(s1), np.asarray(s0))

    @pytest.mark.parametrize("n,d,u", [
        (5760, 960, 247),    # mode-0 RDS
        (9600, 1920, 817),   # mode-2 RDS
        (9600, 800, 147),    # mode-2 audio
        (9600, 3200, 441),   # mode-3 audio
    ])
    def test_resample_matches_gather(self, rng, n, d, u):
        k = 101 * u
        h = _f32(rng.normal(size=k))
        x = _f32(rng.normal(size=(2, n)))
        st = _f32(rng.normal(size=(2, jfir.resample_state_len(k, u))))
        y0, s0 = jfir.fir_block_resample(x, h, st, d, u)
        y1, s1 = jfir.fir_block_resample_mm(x, h, st, d, u)
        ref = np.abs(np.asarray(y0)).max()
        np.testing.assert_allclose(np.asarray(y1), np.asarray(y0),
                                   atol=max(1e-6, 2e-4 * ref))
        np.testing.assert_array_equal(np.asarray(s1), np.asarray(s0))

    def test_resample_mm_falls_back_when_indivisible(self, rng):
        """Block length not divisible by D -> transparent fallback to the
        gather path (still correct)."""
        n, d, u = 5761, 7, 3
        k = 33
        h = _f32(rng.normal(size=k))
        x = _f32(rng.normal(size=(n - n % d + d,)))  # pick n % d != 0
        x = x[: (n // d) * d + 1 + (d - 1)]          # length with n%d!=0
        n_eff = x.shape[-1]
        if n_eff % d == 0:
            x = x[:-1]
            n_eff -= 1
        assert n_eff % d != 0
        # must still satisfy the resampler's own divisibility n*u % d == 0
        while (n_eff * u) % d != 0:
            n_eff -= 1
        x = x[:n_eff]
        st = jnp.zeros((jfir.resample_state_len(k, u),), jnp.float32)
        y0, _ = jfir.fir_block_resample(x, h, st, d, u)
        y1, _ = jfir.fir_block_resample_mm(x, h, st, d, u)
        np.testing.assert_allclose(np.asarray(y1), np.asarray(y0),
                                   atol=1e-5)

    def test_receiver_mxu_matches_conv_dag(self, rng):
        """Full mode-0 stereo+RDS block: mxu_fir DAG vs conv DAG."""
        from sdr_fm import config as cfg
        from sdr_fm.models import receiver as rx
        from sdr_fm.utils import synth
        mc = cfg.get_mode_config(0)
        bs = mc.default_block_size(True)
        res = synth.synthesize_fm(duration_s=0.15, mode=0, with_rds=True,
                                  seed=1)
        blk = jnp.asarray(res.iq_u8[:bs])
        coeffs = rx.design_coeffs(mc)
        o1, s1 = rx.process_block(blk, coeffs, rx.init_state(mc), mc,
                                  stereo=True, with_rds=True, mxu_fir=True)
        o0, s0 = rx.process_block(blk, coeffs, rx.init_state(mc), mc,
                                  stereo=True, with_rds=True,
                                  mxu_fir=False)
        for a in ("left", "right", "mono", "rds_symbols", "fm_demod"):
            np.testing.assert_allclose(
                np.asarray(getattr(o1, a)), np.asarray(getattr(o0, a)),
                atol=1e-4, err_msg=a)
