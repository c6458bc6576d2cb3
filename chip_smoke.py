"""Smoke test of the receiver on one GPU, at real size.

Drives the main path once through the entry points a user calls — the
CLI, ``Receiver``, the wideband front door — and checks every output
against the float64 golden model (``sdr_fm.golden``) and the transmitted
ground truth, then checks the GPU kernels against their plain references:

    0  device     every JAX device is a GPU; card name and power limit
    1  cli        10 s mode-0 stereo+RDS station through ``cli.main``
    2  serving    Receiver(batch_shape=(512,)) on raw u8, 16 stations
    3  modes      modes 1, 2 (with RDS) and 3, one station each
    4  wideband   a 9.6 MS/s capture of 3 stations through ``--wideband``
    5  kernels    PLL kernel vs lax.scan; every FIR vs the golden filters

    python chip_smoke.py                # one GPU, phases 0-5
    python chip_smoke.py --four-cards   # four GPUs: the sharded paths only

Each phase prints one JSON line (name, ok, seconds, largest error and its
limit); a failing check raises, and the script exits non-zero.  The last
line is ``{"ok": true, "device": {...}}``.  Without a GPU it exits 1.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

#: stations of the multi-station phases: (PI, PS name) per seed
STATIONS = [(0x1000 + 0x111 * k, f"STN {k:02d}  ") for k in range(16)]


class CheckFailed(AssertionError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def progress(what: str, t0: float) -> None:
    """A step of a long phase, on stderr: where a stalled run stopped."""
    print(f"# {time.time() - t0:8.1f}s {what}", file=sys.stderr, flush=True)


def report(name: str, t0: float, **fields) -> dict:
    rec = {"phase": name, "ok": True, "seconds": round(time.time() - t0, 3),
           **fields}
    print(json.dumps(rec), flush=True)
    return rec


def _station(k: int, duration_s: float, mode: int = 0, rds: bool = True):
    from sdr_fm.utils import synth
    pi, ps = STATIONS[k % len(STATIONS)]
    return synth.synthesize_fm(
        duration_s=duration_s, mode=mode, seed=100 + k, with_stereo=True,
        with_rds=rds, tone_l=500.0 + 50 * k, tone_r=2500.0 - 70 * k,
        rds_station=synth.StationConfig(pi=pi, ps=ps))


def _separation_db(audio: np.ndarray, fs: float, f_want: float,
                   f_other: float) -> float:
    """Power ratio of two tones in one channel, in dB."""
    spec = np.abs(np.fft.rfft(audio * np.hanning(len(audio)))) ** 2
    freqs = np.fft.rfftfreq(len(audio), 1.0 / fs)
    band = lambda f: spec[np.abs(freqs - f) < 20.0].sum()
    return float(10 * np.log10(band(f_want) / max(band(f_other), 1e-30)))


def _golden_err(outs, gouts, fields) -> tuple[dict, dict]:
    """Largest abs difference per output arm vs the golden blocks:
    (blocks after the first, the first block)."""
    err, cold = {}, {}
    for f in fields:
        ours = np.asarray(getattr(outs, f))
        for b, g in enumerate(gouts[:len(ours)]):
            e = float(np.max(np.abs(ours[b] - getattr(g, f))))
            d = cold if b == 0 else err
            d[f] = max(d.get(f, 0.0), e)
    return err, cold


def _rds_hits(symbols: np.ndarray, sps: int, res) -> tuple[int, int]:
    """(frame matches, decoded info words that were transmitted)."""
    from sdr_fm.models import rds_decode
    dec = rds_decode.decode_robust(symbols, sps)
    sent = {tuple(w) for g in res.rds_info_bits for w in g}
    return (len(dec.frames.matches),
            sum(tuple(w) in sent for w in dec.info_words))


#: tolerances, each with its reason
#: float32 receiver vs float64 golden, per output sample: the PLL arms
#: carry the recurrence's float32 roundoff (tests/test_models_receiver.py)
TOL_LINEAR = 2e-4     # fm_demod, mono
TOL_PLL = 5e-3        # left, right, rds symbols
TOL_PLL_RATIONAL = 6e-3   # modes 1-3 stereo (rational resamplers)
#: the first block starts from the zero state: the quadrature
#: discriminator divides by I^2+Q^2, which is near zero while the RF FIR
#: fills, so float32 roundoff is amplified there (measured 1.7e-3 on the
#: mode-3 fm_demod, H100); every arm, first block only
TOL_COLD = 1e-2
#: PCM adds one 1/16384 quantization step
TOL_PCM = TOL_PLL + 2.0 / 16384


def phase_cli(duration_s: float = 10.0, golden_s: float = 2.0) -> dict:
    """Mode-0 stereo+RDS station through the CLI, in this process."""
    from scipy.io import wavfile

    from sdr_fm import cli, config as cfg
    from sdr_fm.golden import receiver as grx
    from sdr_fm.utils import synth

    t0 = time.time()
    mc = cfg.get_mode_config(0)
    res = _station(0, duration_s)
    pi, ps = STATIONS[0]
    with tempfile.TemporaryDirectory() as d:
        raw, wav = os.path.join(d, "in.raw"), os.path.join(d, "out.wav")
        res.iq_u8.tofile(raw)
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = cli.main([raw, "--mode", "0", "--stereo", "--rds", "--wav",
                           "-o", wav, "--stats"])
        log = err.getvalue()
        check(rc == 0, f"cli exit {rc}: {log}")
        fs, pcm = wavfile.read(wav)
    check(fs == mc.audio_fs and pcm.ndim == 2, f"wav {fs} {pcm.shape}")
    audio = pcm.astype(np.float64) / 16384.0
    lock = int(0.25 * fs)
    sep_l = _separation_db(audio[lock:, 0], fs, 500.0, 2500.0)
    sep_r = _separation_db(audio[lock:, 1], fs, 2500.0, 500.0)
    check(min(sep_l, sep_r) > 30.0, f"separation {sep_l:.1f}/{sep_r:.1f} dB")
    m = re.search(r"RDS station: PI=(\w+) .*PS='([^']*)'", log)
    check(m is not None, f"no RDS station line: {log}")
    check(int(m.group(1), 16) == pi and m.group(2) == ps,
          f"RDS PI/PS {m.group(1)}/{m.group(2)!r}, sent {pi:04X}/{ps!r}")

    bs = mc.default_block_size(True)
    n_g = int(golden_s * mc.rf_fs * 2) // bs * bs
    gouts = grx.run_file(synth.u8_to_float(res.iq_u8[:n_g]), mc,
                         stereo=True, with_rds=True)
    g_lr = np.stack([np.concatenate([g.left for g in gouts]),
                     np.concatenate([g.right for g in gouts])], axis=-1)
    e = float(np.max(np.abs(audio[:len(g_lr)] - g_lr)))
    check(e <= TOL_PCM, f"audio vs golden {e:.3g} > {TOL_PCM}")
    stats = [ln for ln in log.splitlines() if "MS/s" in ln]
    return report("cli", t0, max_err=e, tol=TOL_PCM,
                  separation_db=[sep_l, sep_r], pi=f"{pi:04X}", ps=ps,
                  golden_s=golden_s, stats=stats[-1] if stats else None)


def phase_serving(channels: int = 512, distinct: int = 16,
                  n_blocks: int = 16) -> dict:
    """A 512-channel batch of raw u8 blocks through ``Receiver``."""
    from sdr_fm import config as cfg
    from sdr_fm.golden import receiver as grx
    from sdr_fm.models.receiver import Receiver
    from sdr_fm.utils import synth

    t0 = time.time()
    mc = cfg.get_mode_config(0)
    bs = mc.default_block_size(True)
    dur = n_blocks * bs / 2 / mc.rf_fs + 0.01
    stations = [_station(k, dur) for k in range(distinct)]
    raw = np.stack([s.iq_u8[:n_blocks * bs] for s in stations])
    batch = np.tile(raw, (channels // distinct, 1))
    rx = Receiver(0, stereo=True, with_rds=True, batch_shape=(channels,))
    outs = rx.run(batch)
    left = np.asarray(outs.left)
    check(left.shape == (n_blocks, channels, bs // (2 * mc.rf_decim
                                                    * mc.audio_decim)),
          f"left shape {left.shape}")
    worst, cold = {}, {}
    min_hits = None
    for k, s in enumerate(stations):
        gouts = grx.run_file(synth.u8_to_float(s.iq_u8[:n_blocks * bs]), mc,
                             stereo=True, with_rds=True)
        for row in (k, k + distinct * (channels // distinct - 1)):
            one = type(outs)(*[np.asarray(a)[:, row] for a in outs])
            e, c0 = _golden_err(one, gouts, ("fm_demod", "mono", "left",
                                             "right", "rds_symbols"))
            for f in e:
                worst[f] = max(worst.get(f, 0.0), e[f])
                cold[f] = max(cold.get(f, 0.0), c0[f])
        matches, hits = _rds_hits(np.asarray(outs.rds_symbols)[:, k]
                                  .reshape(-1), mc.rds.sps, s)
        check(matches >= 4 and hits >= matches - 2,
              f"station {k}: {hits} of {matches} RDS words sent")
        min_hits = hits if min_hits is None else min(min_hits, hits)
    for f, tol in (("fm_demod", TOL_LINEAR), ("mono", TOL_LINEAR),
                   ("left", TOL_PLL), ("right", TOL_PLL),
                   ("rds_symbols", TOL_PLL)):
        check(worst[f] <= tol, f"{f} vs golden {worst[f]:.3g} > {tol}")
        check(cold[f] <= TOL_COLD, f"{f} first block {cold[f]:.3g}")
    return report("serving", t0, max_err=max(worst.values()),
                  errors=worst, first_block_errors=cold,
                  tol={"linear": TOL_LINEAR, "pll": TOL_PLL,
                       "first_block": TOL_COLD},
                  channels=channels, distinct=distinct, blocks=n_blocks,
                  min_rds_words=min_hits)


def phase_modes(duration_s: float = 0.3) -> dict:
    """Modes 1, 2 (RDS on) and 3: one station each vs golden."""
    from sdr_fm import config as cfg
    from sdr_fm.golden import receiver as grx
    from sdr_fm.models.receiver import Receiver
    from sdr_fm.utils import synth

    t0 = time.time()
    errors, colds = {}, {}
    for mode in (1, 2, 3):
        mc = cfg.get_mode_config(mode)
        rds = mc.rds is not None
        res = _station(mode, duration_s, mode=mode, rds=rds)
        iq = synth.u8_to_float(res.iq_u8)
        bs = mc.default_block_size(rds)
        n = len(iq) // bs * bs
        check(n >= 2 * bs, f"mode {mode}: {len(iq)} samples < 2 blocks")
        outs = Receiver(mode, stereo=True, with_rds=rds).run(res.iq_u8[:n])
        gouts = grx.run_file(iq[:n], mc, stereo=True, with_rds=rds)
        fields = ("fm_demod", "mono", "left", "right") + (
            ("rds_symbols",) if rds else ())
        e, cold = _golden_err(outs, gouts, fields)
        tols = {"fm_demod": TOL_LINEAR, "mono": TOL_LINEAR,
                "left": TOL_PLL_RATIONAL, "right": TOL_PLL_RATIONAL,
                "rds_symbols": TOL_PLL}
        for f, v in e.items():
            check(v <= tols[f], f"mode {mode} {f} vs golden {v:.3g}")
            check(cold[f] <= TOL_COLD,
                  f"mode {mode} {f} first block {cold[f]:.3g}")
        if rds:
            matches, hits = _rds_hits(np.asarray(outs.rds_symbols)
                                      .reshape(-1), mc.rds.sps, res)
            check(matches >= 4 and hits >= matches - 2,
                  f"mode {mode}: {hits} of {matches} RDS words sent")
        errors[str(mode)], colds[str(mode)] = e, cold
    return report("modes", t0,
                  max_err=max(max(e.values()) for e in errors.values()),
                  errors=errors, first_block_errors=colds,
                  tol={"linear": TOL_LINEAR, "pll": TOL_PLL_RATIONAL,
                       "first_block": TOL_COLD})


def phase_wideband(duration_s: float = 1.5,
                   offsets=(-2.4e6, 0.6e6, 3.0e6),
                   fs_wide: float = 9.6e6) -> dict:
    """A wideband capture through ``cli --wideband``: every PI and PS."""
    from sdr_fm import cli
    from sdr_fm.utils import synth

    t0 = time.time()
    sts = [synth.StationConfig(pi=pi, ps=ps)
           for pi, ps in STATIONS[4:4 + len(offsets)]]
    wb = synth.synthesize_wideband(duration_s, fs_wide, list(offsets),
                                   seed=9, rds_stations=sts)
    with tempfile.TemporaryDirectory() as d:
        raw = os.path.join(d, "wide.raw")
        wb.iq_u8.tofile(raw)
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = cli.main([raw, "--wideband", str(fs_wide),
                           "--offsets=" + ",".join(str(f) for f in offsets),
                           "--mode", "0",
                           "--stereo", "--rds", "--wav", "-o",
                           os.path.join(d, "st"), "--stats"])
        log = err.getvalue()
    check(rc == 0, f"wideband exit {rc}: {log}")
    got = re.findall(r"station (\d+) .*PI=(\w+) PS='([^']*)'", log)
    check(len(got) == len(offsets), f"stations decoded: {log}")
    for k, pi, ps in got:
        want = sts[int(k)]
        check(int(pi, 16) == want.pi and ps == want.ps,
              f"station {k}: PI/PS {pi}/{ps!r}, sent {want.pi:04X}/"
              f"{want.ps!r}")
    stats = [ln for ln in log.splitlines() if "MS/s" in ln]
    return report("wideband", t0, max_err=0.0, tol=0.0,
                  stations=[f"{pi}/{ps}" for _, pi, ps in got],
                  stats=stats[-1] if stats else None)


#: kernel vs scan on the same card: the kernel runs ops.pll.pll_step, the
#: scan's own body, so only FMA contraction can change the last bits of a
#: phase; 1e-4 on the unit-amplitude NCO bounds that with margin
TOL_PLL_KERNEL = 1e-4
#: f32 FIRs vs float64 golden, relative RMS: full float32 accumulation
#: stays near 2e-7 (a TF32 product would show ~3e-4)
TOL_FIR_F32 = 1e-5
#: the u8 front-end's bf16 weight split keeps ~16 weight bits
TOL_FIR_BF16X = 1e-4


def phase_kernels(lanes: int = 1024, steps: int = 5760, n_blocks: int = 4,
                  channels=(1, 512), interpret: bool = False) -> dict:
    """The PLL kernel against the scan, and every FIR against golden."""
    import jax
    import jax.numpy as jnp

    from sdr_fm import config as cfg
    from sdr_fm.golden import filters as gf
    from sdr_fm.models import receiver as rx
    from sdr_fm.ops import fir as jfir
    from sdr_fm.ops import pll as jpll

    t0 = time.time()
    mc = cfg.get_mode_config(0)
    params = (rx.pilot_pll_params(mc), rx.rds_pll_params(mc))
    rng = np.random.default_rng(5)
    c = lanes // 2
    t = np.arange(n_blocks * steps) / mc.if_fs
    df = rng.uniform(-20, 20, (c, 1))
    x = np.stack([0.4 * np.sin(2 * np.pi * (19e3 + df) * t),
                  0.1 * np.sin(2 * np.pi * (114e3 + 6 * df) * t)], axis=1)
    x = jnp.asarray(x + 0.02 * rng.standard_normal(x.shape), jnp.float32)
    x = x.at[..., ::97].set(0.0)           # the x == 0 detector branch
    st = jax.tree.map(
        lambda a, b: jnp.broadcast_to(jnp.stack([a, b], -1), (c, 2)),
        jpll.pll_init(), jpll.pll_init(nco_q_last=1.0))
    fns = [jax.jit(lambda xb, s, k=k: jpll.pll_block_fused(
        xb, s, params, kernel=k, interpret=interpret)) for k in (False, True)]
    sa = sb = st
    pll_err = 0.0
    for b in range(n_blocks):
        xb = x[..., b * steps:(b + 1) * steps]
        ia, qa, sa = fns[0](xb, sa)
        ib, qb, sb = fns[1](xb, sb)
        pll_err = max(pll_err, float(jnp.max(jnp.abs(ia - ib))),
                      float(jnp.max(jnp.abs(qa - qb))))
    state_err = max(float(jnp.max(jnp.abs(u - v))) for u, v in zip(sa, sb))
    check(max(pll_err, state_err) <= TOL_PLL_KERNEL,
          f"PLL kernel vs scan {pll_err:.3g}/{state_err:.3g}")

    fir = {}
    co = rx.design_coeffs(mc)
    r = mc.rds
    n_if = mc.default_block_size(True) // (2 * mc.rf_decim)
    n_rf = n_if * mc.rf_decim
    h3 = jnp.stack([co.stereo, co.pilot, co.rds_channel])
    # taps are runtime arguments, as in the receiver (constant taps would
    # be folded at compile time and hide what the GPU pipeline does)
    sites = {
        "decim_conv": (co.rf, n_rf, lambda x, s, h: jfir.fir_block_decim(
            x, h, s, mc.rf_decim)),
        "decim_mm": (co.rf, n_rf, lambda x, s, h: jfir.fir_block_decim_mm(
            x, h, s, mc.rf_decim)),
        "multi_conv": (h3, n_if, lambda x, s, h: jfir.fir_block_multi(
            x, h, s)),
        "multi_mm": (h3, n_if, lambda x, s, h: jfir.fir_block_multi_mm(
            x, h, s)),
        "resample_gather": (co.rds_resampler, n_if,
                            lambda x, s, h: jfir.fir_block_resample(
                                x, h, s, r.decim, r.upsamp)),
        "resample_mm": (co.rds_resampler, n_if,
                        lambda x, s, h: jfir.fir_block_resample_mm(
                            x, h, s, r.decim, r.upsamp)),
    }
    for cc in channels:
        for name, (h, n, fn) in sites.items():
            h64 = np.asarray(h, np.float64)
            k = h64.shape[-1]
            resamp = name.startswith("resample")
            xs = rng.uniform(-1, 1, (cc, n))
            ss = rng.uniform(-1, 1, (cc, gf.resample_state_len(k, r.upsamp)
                                     if resamp else k - 1))
            y = np.asarray(jax.jit(fn)(jnp.asarray(xs, jnp.float32),
                                       jnp.asarray(ss, jnp.float32), h)[0],
                           np.float64)
            rows = range(min(cc, 2))
            if resamp:
                g = [gf.block_fir_resample(xs[i], h64, ss[i], r.decim,
                                           r.upsamp)[0] for i in rows]
            elif h64.ndim == 2:
                g = [np.stack([gf.block_fir(xs[i], hh, ss[i])[0]
                               for hh in h64]) for i in rows]
            else:
                g = [gf.block_fir_decim(xs[i], h64, ss[i], mc.rf_decim)[0]
                     for i in rows]
            g = np.stack(g)
            e = y[:len(g)] - g
            fir[f"{name}@{cc}"] = float(np.sqrt(np.mean(e ** 2))
                                        / np.sqrt(np.mean(g ** 2)))
        # the u8 front-end: exact-bf16 samples, split bf16 weights
        u8 = rng.integers(0, 256, (cc, 2, n_rf))
        xs = (u8 - 128.0) / 128.0
        ss = rng.integers(-128, 128, (cc, 2, mc.rf_taps - 1)) / 128.0
        y = np.asarray(jax.jit(
            lambda x, s, h: jfir.fir_block_decim_mm_bf16x(
                x, h, s, mc.rf_decim)[0])(
            jnp.asarray(xs, jnp.bfloat16), jnp.asarray(ss, jnp.bfloat16),
            co.rf), np.float64)
        h64 = np.asarray(co.rf, np.float64)
        g = gf.block_fir_decim(xs[0, 0], h64, ss[0, 0], mc.rf_decim)[0]
        fir[f"decim_mm_bf16x@{cc}"] = float(
            np.sqrt(np.mean((y[0, 0] - g) ** 2)) / np.sqrt(np.mean(g ** 2)))
    for name, v in fir.items():
        tol = TOL_FIR_BF16X if "bf16x" in name else TOL_FIR_F32
        check(v <= tol, f"FIR {name} rel RMS {v:.3g} > {tol}")
    return report("kernels", t0, max_err=max(pll_err, state_err),
                  tol=TOL_PLL_KERNEL, pll_lanes=lanes, pll_blocks=n_blocks,
                  pll_state_err=state_err, fir_rel_rms=fir,
                  fir_tol={"f32": TOL_FIR_F32, "bf16x": TOL_FIR_BF16X})


#: time-sharded PLL arms vs contiguous after the warm-up overlap: relative
#: RMS (tests/test_parallel.py); linear arms must match to roundoff
TOL_SHARD_PLL_REL = 1e-4
TOL_SHARD_LINEAR = 1e-5
#: channel-sharded vs one card: batch-size-dependent matmul roundoff
#: through the locked PLL (models.receiver.process_block_channel_chunked)
TOL_CHANNEL_SHARD = 1e-4


def phase_four_cards(devices, channels: int = 512, distinct: int = 16,
                     n_blocks: int = 8, archive_s: float = 60.0,
                     tile_s: float = 10.0, mesh2d_s: float = 10.0) -> dict:
    """The sharded paths over four devices against one device."""
    import jax
    from jax.sharding import Mesh

    from sdr_fm import config as cfg
    from sdr_fm.models.receiver import Receiver
    from sdr_fm.parallel import channel_sharded_run, time_sharded_receive
    from sdr_fm.parallel.time_shard import (assemble_time_chunks,
                                            default_block_if,
                                            time_sharded_receive_chunked)
    from sdr_fm.utils import synth

    t0 = time.time()
    n_dev = len(devices)
    mc = cfg.get_mode_config(0)
    errors = {}

    # --- channel sharding: C channels, C/4 per card --------------------
    bs = mc.default_block_size(True)
    dur = n_blocks * bs / 2 / mc.rf_fs + 0.01
    raw = np.stack([_station(k, dur).iq_u8[:n_blocks * bs]
                    for k in range(distinct)])
    batch = np.tile(raw, (channels // distinct, 1))
    progress("channel_sharded_run", t0)
    outs, _ = channel_sharded_run(batch, Mesh(np.array(devices), ("ch",)),
                                  0, stereo=True, with_rds=True)
    check(len({s.device for s in outs.left.addressable_shards}) == n_dev,
          "channel-sharded output not spread over every card")
    progress("channel reference on one device", t0)
    with jax.default_device(devices[0]):
        ref = Receiver(0, stereo=True, with_rds=True,
                       batch_shape=(channels,)).run(batch)
    skip = 2                                   # PLL acquisition blocks
    for f in ("fm_demod", "mono", "left", "right", "rds_symbols"):
        errors[f"channel/{f}"] = float(np.max(np.abs(
            np.asarray(getattr(outs, f))[skip:]
            - np.asarray(getattr(ref, f))[skip:])))
        check(errors[f"channel/{f}"] <= TOL_CHANNEL_SHARD,
              f"channel-sharded {f}: {errors[f'channel/{f}']:.3g}")

    # --- time sharding of a long recording -----------------------------
    block_raw = default_block_if(mc, True) * 2 * mc.rf_decim
    n_total = int(archive_s * mc.rf_fs * 2) // (n_dev * block_raw) \
        * n_dev * block_raw
    base = synth.u8_to_float(_station(1, tile_s).iq_u8)
    iq = np.resize(base, n_total)              # tiled: same input for both
    mesh = Mesh(np.array(devices), ("time",))
    progress(f"time_sharded_receive of {n_total / 2 / mc.rf_fs:.1f} s", t0)
    sharded = time_sharded_receive(iq, mesh, 0, stereo=True, with_rds=True)
    progress("time_sharded_receive_chunked", t0)
    chunks = assemble_time_chunks(list(time_sharded_receive_chunked(
        iq, mesh, 0, stereo=True, with_rds=True)))
    progress("contiguous reference on one device", t0)
    with jax.default_device(devices[0]):
        cont = Receiver(0, stereo=True, with_rds=True).run(iq)
    skip = 8000
    for f in ("fm_demod", "mono", "left", "right", "rds_symbols"):
        want = np.asarray(getattr(cont, f)).reshape(-1)
        for name, got in (("single", np.asarray(getattr(sharded, f))),
                          ("chunked", chunks[f])):
            check(got.shape == want.shape, f"{name} {f} {got.shape}")
            if f in ("fm_demod", "mono"):
                e = float(np.max(np.abs(got - want)))
                check(e <= TOL_SHARD_LINEAR, f"time {name} {f}: {e:.3g}")
            else:
                e = float(np.sqrt(np.mean((got[skip:] - want[skip:]) ** 2))
                          / np.sqrt(np.mean(want[skip:] ** 2)))
                check(e <= TOL_SHARD_PLL_REL, f"time {name} {f}: {e:.3g}")
            errors[f"time_{name}/{f}"] = e
        errors[f"chunked_vs_single/{f}"] = float(np.max(np.abs(
            chunks[f] - np.asarray(getattr(sharded, f)))))

    # --- 2 x 2 channel x time mesh --------------------------------------
    block_raw = default_block_if(mc, False) * 2 * mc.rf_decim
    n2 = int(mesh2d_s * mc.rf_fs * 2) // (2 * block_raw) * 2 * block_raw
    iqc = np.stack([iq[:n2], np.resize(base[::-1], n2)])
    mesh2 = Mesh(np.array(devices).reshape(2, n_dev // 2), ("ch", "time"))
    progress("2 x 2 channel x time mesh", t0)
    out2 = time_sharded_receive(iqc, mesh2, 0, stereo=True, with_rds=False,
                                axis="time", batch_axis="ch")
    with jax.default_device(devices[0]):
        for row in range(2):
            ref2 = Receiver(0, stereo=True).run(iqc[row])
            for f in ("fm_demod", "mono"):
                e = float(np.max(np.abs(np.asarray(getattr(out2, f))[row]
                                        - np.asarray(getattr(ref2, f))
                                        .reshape(-1))))
                check(e <= TOL_SHARD_LINEAR, f"2x2 row {row} {f}: {e:.3g}")
                errors[f"mesh2x2_{row}/{f}"] = max(
                    errors.get(f"mesh2x2_{row}/{f}", 0.0), e)
    return report("four_cards", t0, max_err=max(errors.values()),
                  errors=errors,
                  tol={"linear": TOL_SHARD_LINEAR,
                       "pll_rel_rms": TOL_SHARD_PLL_REL,
                       "channel": TOL_CHANNEL_SHARD},
                  devices=n_dev, channels=channels,
                  archive_s=n_total / 2 / mc.rf_fs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths, over four GPUs")
    args = ap.parse_args(argv)

    import jax

    from sdr_fm.utils import runtime

    try:
        devs = runtime.require_gpu()
    except RuntimeError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    t0 = time.time()
    cache = runtime.enable_compile_cache()
    card = runtime.card_info()
    print(card, flush=True)
    report("device", t0, max_err=0.0, tol=0.0, card=card,
           kind=devs[0].device_kind, count=len(devs), jax=jax.__version__,
           xla_flags=os.environ.get("XLA_FLAGS", ""), compile_cache=cache)
    if args.four_cards:
        check(len(devs) >= 4, f"--four-cards needs 4 GPUs, found {len(devs)}")
        devs = devs[:4]
        phase_four_cards(devs)
    else:
        phase_cli()
        phase_serving()
        phase_modes()
        phase_wideband()
        phase_kernels()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
