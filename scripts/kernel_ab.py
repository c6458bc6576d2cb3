"""Measure the receiver's kernel choices on the GPU.

Times the whole mode-0 stereo+RDS block (raw u8 input, a jitted scan over
blocks, ``block_until_ready``) for each combination of the two selectors
of ``models.receiver.select_kernels`` — the PLL recurrence as the GPU
kernel or as ``lax.scan``, and the FIRs as banded matmuls or convolutions
— at one channel and at 512 channels, and the PLL recurrence alone.  It
also measures each FIR stage against the float64 golden filters at the
real block width under both ``Precision.HIGH`` and ``HIGHEST``, and writes
the optimized HLO of one conv and one matmul FIR so the precision each
lowers to can be read.

    python scripts/kernel_ab.py                 # on the GPU
    JAX_PLATFORMS=cpu python scripts/kernel_ab.py --small   # rehearsal

Prints one JSON line per measurement and writes them, with the HLO
excerpts, under ``--out`` (default ``kernel_ab_out/`` in the checkout).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

OUT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "kernel_ab_out")


def emit(rec: dict, sink: list) -> None:
    sink.append(rec)
    print(json.dumps(rec), flush=True)


def time_fn(fn, *args, reps: int) -> list[float]:
    import jax
    jax.block_until_ready(fn(*args))          # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return ts


def block_ab(channels: int, n_blocks: int, reps: int, sink: list,
             variants) -> None:
    """Whole mode-0 stereo+RDS block, per variant, ms per block."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from sdr_fm import config as cfg
    from sdr_fm.models import receiver as rx
    from sdr_fm.utils import synth

    mc = cfg.get_mode_config(0)
    bs = mc.default_block_size(with_rds=True)
    res = synth.synthesize_fm(duration_s=n_blocks * bs / 2 / mc.rf_fs + 0.01,
                              mode=0, with_stereo=True, with_rds=True, seed=0)
    src = res.iq_u8[:n_blocks * bs].reshape(n_blocks, bs)
    if channels > 1:
        src = np.broadcast_to(src[:, None, :], (n_blocks, channels, bs))
    blocks = jnp.asarray(np.ascontiguousarray(src))
    coeffs = rx.design_coeffs(mc)
    state = rx.init_state(mc, batch_shape=(channels,) if channels > 1 else ())

    outs = {}
    for pll_kernel, mxu_fir in variants:
        @jax.jit
        def run(blocks, state):
            def step(st, blk):
                out, st = rx.process_block(blk, coeffs, st, mc, stereo=True,
                                           with_rds=True,
                                           pll_kernel=pll_kernel,
                                           mxu_fir=mxu_fir)
                return st, (out.left, out.rds_symbols)
            return lax.scan(step, state, blocks)[1]

        t0 = time.perf_counter()
        try:
            ts = time_fn(run, blocks, state, reps=reps)
        except Exception as e:                     # keep the other variants
            emit({"what": "block_error", "channels": channels,
                  "variant": [pll_kernel, mxu_fir],
                  "error": f"{type(e).__name__}: {e}"[:2000]}, sink)
            continue
        compile_s = time.perf_counter() - t0 - sum(ts)
        outs[(pll_kernel, mxu_fir)] = [np.asarray(o) for o in run(blocks,
                                                                   state)]
        ms = [t / n_blocks * 1e3 for t in ts]
        emit({"what": "block", "channels": channels, "pll_kernel": pll_kernel,
              "mxu_fir": mxu_fir, "ms_per_block_median": float(np.median(ms)),
              "ms_per_block_min": float(np.min(ms)),
              "ms_per_block_max": float(np.max(ms)), "reps": reps,
              "n_blocks": n_blocks, "compile_s": compile_s}, sink)
    if not outs:
        return
    base = outs[next(iter(outs))]
    for v, o in outs.items():
        emit({"what": "block_agreement", "channels": channels,
              "variant": list(v), "vs": list(next(iter(outs))),
              "left_max_abs": float(np.max(np.abs(o[0] - base[0]))),
              "rds_max_abs": float(np.max(np.abs(o[1] - base[1])))}, sink)


def pll_ab(lanes: int, n_steps: int, n_blocks: int, reps: int, sink: list,
           tiles, interpret: bool) -> None:
    """PLL recurrence alone: kernel vs scan on ``lanes`` lanes over chained
    blocks, with pilot-like inputs (tone + noise, per-lane offsets)."""
    import jax
    import jax.numpy as jnp

    from sdr_fm import config as cfg
    from sdr_fm.models import receiver as rx
    from sdr_fm.ops import pll as jpll

    mc = cfg.get_mode_config(0)
    params = (rx.pilot_pll_params(mc), rx.rds_pll_params(mc))
    c = lanes // 2
    rng = np.random.default_rng(5)
    t = np.arange(n_blocks * n_steps) / mc.if_fs
    df = rng.uniform(-20, 20, (c, 1))
    ph = rng.uniform(0, 2 * np.pi, (c, 1))
    x1 = 0.4 * np.sin(2 * np.pi * (19e3 + df) * t + ph)
    x2 = 0.1 * np.sin(2 * np.pi * (114e3 + 6 * df) * t + 3 * ph)
    x = np.stack([x1, x2], axis=1) + 0.02 * rng.standard_normal(
        (c, 2, t.size))
    x = jnp.asarray(x, jnp.float32)
    st0 = jax.tree.map(
        lambda a, b: jnp.broadcast_to(jnp.stack([a, b], -1), (c, 2)),
        jpll.pll_init(), jpll.pll_init(nco_q_last=1.0))

    def chain(kernel, **kw):
        fn = jax.jit(lambda xb, st: jpll.pll_block_fused(
            xb, st, params, kernel=kernel, interpret=interpret, **kw))
        st, outs = st0, []
        for b in range(n_blocks):
            i_, q_, st = fn(x[..., b * n_steps:(b + 1) * n_steps], st)
            outs.append((i_, q_))
        return fn, outs, st

    scan_fn, scan_outs, scan_st = chain(False)
    xb = x[..., :n_steps]
    runs = [("scan", scan_fn, scan_outs, scan_st)]
    kern_fn, kern_outs, kern_st = chain(True)
    runs.append(("kernel", kern_fn, kern_outs, kern_st))
    if not interpret:
        from sdr_fm.ops import pll_kernel
        for lane_tile, tile_t in tiles:
            def kfn(xb, st, lane_tile=lane_tile, tile_t=tile_t):
                aw0 = jnp.arctan2(st.feedback_q, st.feedback_i)
                return pll_kernel.pll_angles(
                    jnp.moveaxis(xb, -1, 0),
                    (st.integrator, st.phase_est, st.osc_phase, aw0),
                    tuple(jnp.asarray(v, jnp.float32) for v in (
                        [p.norm_bandwidth * 2.666 for p in params],
                        [p.norm_bandwidth ** 2 * 3.555 for p in params],
                        [2 * np.pi * p.freq / p.fs for p in params],
                        [p.wrap_modulus for p in params])),
                    lane_tile=lane_tile, tile_t=tile_t)
            try:
                ts = time_fn(jax.jit(kfn), xb, st0, reps=reps)
            except Exception as e:                 # keep the other tiles
                emit({"what": "pll_tile_error", "lane_tile": lane_tile,
                      "tile_t": tile_t,
                      "error": f"{type(e).__name__}: {e}"[:2000]}, sink)
                continue
            emit({"what": "pll_angles_only", "lanes": lanes,
                  "lane_tile": lane_tile, "tile_t": tile_t,
                  "programs": -(-lanes // lane_tile),
                  "ms_median": float(np.median(ts)) * 1e3,
                  "ms_min": float(np.min(ts)) * 1e3}, sink)
    for name, fn, _, _ in runs:
        ts = time_fn(fn, xb, st0, reps=reps)
        emit({"what": "pll_block_fused", "impl": name, "lanes": lanes,
              "steps": n_steps, "ms_median": float(np.median(ts)) * 1e3,
              "ms_min": float(np.min(ts)) * 1e3}, sink)
    errs = []
    for b in range(n_blocks):
        errs.append(float(np.max(np.abs(np.asarray(scan_outs[b][0])
                                        - np.asarray(kern_outs[b][0])))))
    emit({"what": "pll_kernel_vs_scan", "lanes": lanes, "blocks": n_blocks,
          "steps": n_steps, "nco_i_max_abs_per_block": errs,
          "state_max_abs": {f: float(np.max(np.abs(
              np.asarray(getattr(scan_st, f))
              - np.asarray(getattr(kern_st, f))))) for f in scan_st._fields}},
         sink)


def precision_ab(channels_list, sink: list) -> None:
    """Every FIR stage vs the float64 golden at the real block width."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from sdr_fm import config as cfg
    from sdr_fm.golden import filters as gf
    from sdr_fm.models import receiver as rx
    from sdr_fm.ops import fir as jfir

    rng = np.random.default_rng(7)
    stages = []
    for mode in (0, 2):
        mc = cfg.get_mode_config(mode)
        co = rx.design_coeffs(mc)
        n_if = mc.default_block_size(True) // (2 * mc.rf_decim)
        n_rf = n_if * mc.rf_decim
        r = mc.rds
        stages += [
            (f"m{mode}_rf", "decim", co.rf, mc.rf_decim, 1, n_rf),
            (f"m{mode}_bandpass", "multi",
             jnp.stack([co.stereo, co.pilot, co.rds_channel]), 1, 1, n_if),
            (f"m{mode}_rds_carrier", "decim", co.rds_carrier, 1, 1, n_if),
            (f"m{mode}_rds_resampler", "resample", co.rds_resampler, r.decim,
             r.upsamp, n_if),
            (f"m{mode}_rds_rrc", "decim", co.rds_rrc, 1, 1,
             n_if * r.upsamp // r.decim),
        ]
        if mc.audio_upsamp > 1:
            stages.append((f"m{mode}_audio", "resample", co.audio,
                           mc.audio_decim, mc.audio_upsamp, n_if))
        else:
            stages.append((f"m{mode}_audio", "decim", co.audio,
                           mc.audio_decim, 1, n_if))

    for prec_name in ("HIGH", "HIGHEST"):
        jfir.PRECISION = getattr(lax.Precision, prec_name)
        jax.clear_caches()
        for c in channels_list:
            for name, kind, h, d, u, n in stages:
                h64 = np.asarray(h, np.float64)
                k = h64.shape[-1]
                x = rng.uniform(-1, 1, (c, n))
                if kind == "resample":
                    st = rng.uniform(-1, 1, (c, gf.resample_state_len(k, u)))
                else:
                    st = rng.uniform(-1, 1, (c, k - 1))
                g = []
                for row in range(min(c, 4)):
                    if kind == "decim":
                        g.append(gf.block_fir_decim(x[row], h64, st[row],
                                                    d)[0])
                    elif kind == "resample":
                        g.append(gf.block_fir_resample(x[row], h64, st[row],
                                                       d, u)[0])
                    else:
                        g.append(np.stack([gf.block_fir(x[row], hh,
                                                        st[row])[0]
                                           for hh in h64]))
                g = np.stack(g)
                xj = jnp.asarray(x, jnp.float32)
                sj = jnp.asarray(st, jnp.float32)
                if kind == "decim":
                    forms = {"conv": lambda xj, sj: jfir.fir_block_decim(
                                 xj, h, sj, d),
                             "mm": lambda xj, sj: jfir.fir_block_decim_mm(
                                 xj, h, sj, d)}
                elif kind == "resample":
                    forms = {"gather": lambda xj, sj: jfir.fir_block_resample(
                                 xj, h, sj, d, u),
                             "mm": lambda xj, sj: jfir.fir_block_resample_mm(
                                 xj, h, sj, d, u)}
                else:
                    forms = {"conv": lambda xj, sj: jfir.fir_block_multi(
                                 xj, h, sj),
                             "mm": lambda xj, sj: jfir.fir_block_multi_mm(
                                 xj, h, sj)}
                for form, fn in forms.items():
                    y = np.asarray(jax.jit(fn)(xj, sj)[0],
                                   np.float64)[:len(g)]
                    err = y - g
                    emit({"what": "fir_precision", "stage": name,
                          "form": form, "precision": prec_name,
                          "channels": c, "n_in": n, "taps": int(k),
                          "rel_rms": float(np.sqrt(np.mean(err ** 2))
                                           / np.sqrt(np.mean(g ** 2))),
                          "max_abs": float(np.max(np.abs(err)))}, sink)
    jfir.PRECISION = lax.Precision.HIGH
    jax.clear_caches()


def hlo_dump(sink: list, out_dir: str) -> None:
    """Optimized HLO of one conv FIR, one banded-matmul FIR and the bf16x
    front-end: what ``Precision.HIGH`` and ``DEFAULT`` lower to."""
    import jax
    import jax.numpy as jnp

    from sdr_fm.ops import fir as jfir

    os.makedirs(out_dir, exist_ok=True)
    h = jnp.ones((151,), jnp.float32) / 151
    x = jnp.ones((512, 57600), jnp.float32)
    st = jnp.zeros((512, 150), jnp.float32)
    xb = x.astype(jnp.bfloat16)
    for name, fn, args in (
            ("conv_decim", lambda x, s: jfir.fir_block_decim(x, h, s, 10),
             (x, st)),
            ("mm_decim", lambda x, s: jfir.fir_block_decim_mm(x, h, s, 10),
             (x, st)),
            ("mm_bf16x", lambda x, s: jfir.fir_block_decim_mm_bf16x(
                x, h, s, 10), (xb, st.astype(jnp.bfloat16)))):
        text = jax.jit(fn).lower(*args).compile().as_text()
        with open(os.path.join(out_dir, f"hlo_{name}.txt"), "w") as f:
            f.write(text)
        keep = [ln.strip()[:400] for ln in text.splitlines()
                if any(k in ln for k in ("custom_call_target", "algorithm",
                                         "precision", "cudnn", "gemm",
                                         "tf32", "operand_precision"))]
        emit({"what": "hlo", "fir": name, "lines": keep[:12]}, sink)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--small", action="store_true",
                    help="tiny sizes for a CPU rehearsal")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--skip", default="",
                    help="comma list of phases to skip: "
                         "hlo,pll,precision,block")
    ap.add_argument("--out", default=OUT_DIR,
                    help="directory for results.jsonl and the HLO text")
    args = ap.parse_args(argv)
    skip = set(filter(None, args.skip.split(",")))

    import jax
    on_gpu = jax.default_backend() == "gpu"
    if not on_gpu and not args.small:
        print("no GPU: run with --small on the CPU", file=sys.stderr)
        return 1
    sink: list = []
    dev = jax.devices()[0]
    info = {"what": "device", "platform": dev.platform,
            "kind": dev.device_kind, "count": len(jax.devices()),
            "jax": jax.__version__}
    if on_gpu:
        from sdr_fm.utils import runtime
        info["nvidia_smi"] = runtime.card_info()
    emit(info, sink)

    big = 16 if args.small else 512
    variants = ([(True, False), (False, False), (True, True), (False, True)]
                if on_gpu else [(False, False), (False, True)])
    phases = [
        ("hlo", lambda: hlo_dump(sink, args.out) if on_gpu else None),
        ("pll", lambda: pll_ab(
            8 if args.small else 1024, 300 if args.small else 5760,
            2 if args.small else 4, args.reps, sink,
            [(8, 16), (16, 16), (32, 16), (32, 32), (64, 16)],
            interpret=not on_gpu)),
        ("precision", lambda: precision_ab([1, big], sink)),
        ("block", lambda: [block_ab(c, 2 if args.small else 8, args.reps,
                                    sink, variants) for c in (1, big)]),
    ]
    failed = []
    for name, run in phases:
        if name in skip:
            continue
        try:
            run()
        except Exception as e:                     # measure what still runs
            failed.append(name)
            emit({"what": "phase_error", "phase": name,
                  "error": f"{type(e).__name__}: {e}"[:4000]}, sink)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "results.jsonl"), "w") as f:
        for rec in sink:
            f.write(json.dumps(rec) + "\n")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
