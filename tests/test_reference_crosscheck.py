"""Cross-validation against the UPSTREAM reference implementation itself.

When the reference checkout is present (read-only at /root/reference),
import its Python model library and compare our golden layer to it on
identical inputs — the strongest possible parity evidence, mirroring the
spec's own "bit equivalence is expected" gate (SURVEY.md §4.2).  Skipped
cleanly when the reference tree is absent.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest

REF_LIB = "/root/reference/model/fmSupportLib.py"

pytestmark = pytest.mark.skipif(not os.path.exists(REF_LIB),
                                reason="reference checkout not present")


@pytest.fixture(scope="module")
def ref():
    spec = importlib.util.spec_from_file_location("ref_fmSupportLib", REF_LIB)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


from sdr_fm.golden import demod as gdemod
from sdr_fm.golden import filters as gfilt
from sdr_fm.golden import pll as gpll
from sdr_fm.golden import rds as grds
from sdr_fm.golden import spectrum as gspec


class TestCoefficients:
    def test_lowpass(self, ref):
        np.testing.assert_allclose(gfilt.lowpass_taps(101, 240e3, 16e3),
                                   ref.impResponse(101, 240e3, 16e3),
                                   atol=1e-12)

    def test_bandpass(self, ref):
        np.testing.assert_allclose(
            gfilt.bandpass_taps(151, 240e3, 18.5e3, 19.5e3),
            ref.bandPass(151, 240e3, 18.5e3, 19.5e3), atol=1e-12)

    def test_rrc(self, ref):
        np.testing.assert_allclose(gfilt.rrc_taps(26 * 2375.0, 101),
                                   ref.impulseResponseRootRaisedCosine(
                                       26 * 2375.0, 101), atol=1e-12)


class TestKernels:
    def test_decimating_fir_streaming(self, ref, rng):
        h = gfilt.lowpass_taps(101, 240e3, 16e3)
        x = rng.normal(size=4000)
        ours_state = np.zeros(100)
        ref_state = np.zeros(100)
        for b in range(2):
            blk = x[b * 2000:(b + 1) * 2000]
            ours, ours_state = gfilt.block_fir_decim(blk, h, ours_state, 5)
            theirs, ref_state = ref.convolveBlockFastFIR(blk, h,
                                                         ref_state, 5)
            np.testing.assert_allclose(ours, theirs, atol=1e-9)

    def test_rational_resampler_streaming(self, ref, rng):
        u, d = 147, 800
        h = gfilt.lowpass_taps(101 * u, 240e3 * u, 16e3)
        n = 1600
        x = rng.normal(size=2 * n)
        ours_state = np.zeros(gfilt.resample_state_len(len(h), u))
        ref_state = np.zeros(len(h) - 1)
        for b in range(2):
            blk = x[b * n:(b + 1) * n]
            ours, ours_state = gfilt.block_fir_resample(blk, h, ours_state,
                                                        d, u)
            theirs, ref_state = ref.convolveBlockResampleFIR(
                blk, h, ref_state, d, u)
            np.testing.assert_allclose(ours, theirs, atol=1e-9,
                                       err_msg=f"block {b}")

    def test_fm_demod(self, ref, rng):
        i = rng.normal(size=1000) + 2.0
        q = rng.normal(size=1000)
        ours, _ = gdemod.fm_demod_quad(i, q, np.zeros(2))
        theirs, _ = ref.compEffDemod(i, q, np.zeros(2))
        np.testing.assert_allclose(ours, theirs, atol=1e-9)

    def test_pll_streaming(self, ref):
        fs = 240e3
        t = np.arange(4000) / fs
        x = 0.4 * np.sin(2 * np.pi * 19015 * t + 0.2)
        ours_state = gpll.PllState()  # defaults mirror [0,0,1,0,1,0,1]
        ref_state = [0.0, 0.0, 1.0, 0.0, 1.0, 0.0, 1.0]
        for b in range(2):
            blk = x[b * 2000:(b + 1) * 2000]
            oi, oq, ours_state = gpll.fm_pll(blk, 19e3, fs, ours_state,
                                             nco_scale=2.0)
            ti, tq, ref_state = ref.fmPll(blk, 19e3, fs, ref_state,
                                          ncoScale=2.0)
            np.testing.assert_allclose(oi, ti, atol=1e-9)
            np.testing.assert_allclose(oq, tq, atol=1e-9)


class TestSpectrum:
    def test_psd(self, ref, rng):
        fs = 240e3
        x = np.sin(2 * np.pi * 19e3 * np.arange(4096) / fs)
        _, ours = gspec.estimate_psd(x, 512, fs)
        theirs = ref.estimatePSD(x, 512, fs)
        # reference returns (freq, psd) or psd depending on version
        theirs_psd = theirs[1] if isinstance(theirs, tuple) else theirs
        np.testing.assert_allclose(ours, np.asarray(theirs_psd).reshape(-1),
                                   atol=1e-6)


class TestReferenceBinary:
    """Build the reference's SHIPPING C++ mono binary (threadMonoOnly) and
    compare its PCM output bit-for-bit against our chain on the same
    synthetic station — the reference's own golden-equivalence gate
    (SURVEY.md §4.2) executed against the real artifact."""

    @pytest.fixture(scope="class")
    def ref_binary(self, tmp_path_factory):
        import shutil
        import subprocess
        if shutil.which("g++") is None:
            pytest.skip("no C++ toolchain")
        exe = str(tmp_path_factory.mktemp("refbin") / "refMono")
        r = subprocess.run(
            ["g++", "-O3", "-pthread", "-std=c++11",
             "/root/reference/src/threadMonoOnly.cpp", "-o", exe],
            capture_output=True, timeout=300)
        if r.returncode != 0:
            pytest.skip(f"reference build failed: {r.stderr[:200]}")
        return exe

    def test_mono_pcm_within_one_lsb(self, ref_binary, tmp_path):
        import subprocess
        import sys

        from sdr_fm.utils import synth
        res = synth.synthesize_fm(duration_s=0.25, mode=0, seed=52)
        raw = tmp_path / "x.raw"
        res.iq_u8.tofile(raw)

        with open(raw, "rb") as f:
            ref = subprocess.run([ref_binary, "0"], stdin=f,
                                 capture_output=True, timeout=300)
        # the binary exits via exit(1) at stdin EOF by design
        ref_pcm = np.frombuffer(ref.stdout, dtype=np.int16).astype(float)
        assert len(ref_pcm) > 0, ref.stderr.decode()[:300]

        ours = subprocess.run(
            [sys.executable, "-m", "sdr_fm.cli", "--mode", "0", str(raw)],
            capture_output=True, timeout=500,
            env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
                 "PYTHONPATH": "/root/repo", "HOME": "/root"})
        assert ours.returncode == 0, ours.stderr.decode()[:300]
        our_pcm = np.frombuffer(ours.stdout, dtype=np.int16).astype(float)

        # our mono is delay-matched (+75 IF = 15 audio samples at decim
        # 10/5); the reference mono-only build applies no delay
        d = 15
        n = min(len(ref_pcm), len(our_pcm) - d)
        assert n > 8000
        err = np.abs(ref_pcm[:n] - our_pcm[d:d + n])
        assert err.max() <= 1 and err.mean() < 0.05, (err.max(), err.mean())


    def test_mode2_gain_quirk_measured(self, ref_binary, tmp_path):
        """Empirically pin the documented C++ x(U+1) resampler-gain
        divergence (src/filter.cpp:213 / threadMonoOnly.cpp:396 vs the
        Python model's xU): the binary's mode-2 audio must be exactly
        (U+1)/U = 148/147 times ours, shape-identical."""
        import subprocess
        import sys

        from sdr_fm.utils import synth
        res = synth.synthesize_fm(duration_s=0.25, mode=2, seed=52,
                                  with_rds=False)
        raw = tmp_path / "x2.raw"
        res.iq_u8.tofile(raw)

        with open(raw, "rb") as f:
            ref = subprocess.run([ref_binary, "2"], stdin=f,
                                 capture_output=True, timeout=300)
        ref_pcm = np.frombuffer(ref.stdout, dtype=np.int16).astype(float)
        assert len(ref_pcm) > 0, ref.stderr.decode()[:300]

        ours = subprocess.run(
            [sys.executable, "-m", "sdr_fm.cli", "--mode", "2", str(raw)],
            capture_output=True, timeout=500,
            env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
                 "PYTHONPATH": "/root/repo", "HOME": "/root"})
        assert ours.returncode == 0, ours.stderr.decode()[:300]
        our_pcm = np.frombuffer(ours.stdout, dtype=np.int16).astype(float)

        # our delay-matching offset is 75 IF * 147/800 = 13.78 audio
        # samples — align at the best integer lag
        n = min(len(ref_pcm), len(our_pcm)) - 20
        a = ref_pcm[500:n]
        best = max(range(10, 18), key=lambda d: np.dot(
            a, our_pcm[500 + d:n + d]))
        b = our_pcm[500 + best:n + best]
        corr = np.corrcoef(a, b)[0, 1]
        ratio = np.dot(a, b) / np.dot(b, b)
        assert corr > 0.995, corr
        assert abs(ratio - 148.0 / 147.0) < 3e-3, ratio


def _exec_reference_script(path, argv, run_dir, patches=()):
    """Execute an upstream module-level model script (they are
    ``if __name__ == "__main__"`` programs, not importable functions) with
    patched argv, a headless matplotlib, silenced prints, and cwd set so
    their hard-coded '../data/...' input paths resolve into ``run_dir``'s
    parent.  ``patches`` are (old, new) source substitutions for script-vs-
    library drift that otherwise crashes the script as checked in (each
    must match exactly once).  Returns the script's global namespace."""
    import builtins

    import matplotlib
    matplotlib.use("Agg", force=True)
    src = open(path).read()
    for a, b in patches:
        assert src.count(a) == 1, (a, src.count(a))
        src = src.replace(a, b)
    g = {"__name__": "__main__", "__file__": path}
    old_argv, old_cwd = sys.argv, os.getcwd()
    realprint = builtins.print
    sys.path.insert(0, "/root/reference/model")
    os.chdir(run_dir)
    sys.argv = argv
    builtins.print = lambda *a, **k: None   # per-block chatter
    try:
        exec(compile(src, path, "exec"), g)
    finally:
        builtins.print = realprint
        sys.argv = old_argv
        os.chdir(old_cwd)
        sys.path.remove("/root/reference/model")
    return g


@pytest.fixture(scope="module")
def station_04s(tmp_path_factory):
    """0.4 s synthesized stereo+RDS station written where the upstream
    scripts expect their inputs (both hard-coded filenames)."""
    from sdr_fm.utils import synth
    base = tmp_path_factory.mktemp("upstream")
    (base / "model_run").mkdir()
    d = base / "data" / "lab3_iq_samples"
    d.mkdir(parents=True)
    res = synth.synthesize_fm(duration_s=0.4, mode=0, seed=7,
                              with_stereo=True, with_rds=True,
                              noise_std=0.01)
    res.iq_u8.tofile(d / "samples8.raw")        # fmRDS.py:104
    res.iq_u8.tofile(d / "stereo_l0_r9.raw")    # stereo.py:82
    return base, synth.u8_to_float(res.iq_u8)


class TestCdrCrosscheck:
    """Pin golden.rds.cdr to the executed ``ref.CDR``
    (model/fmSupportLib.py:103-201) — the trickiest RDS decode stage
    (data-dependent sampling-grid restarts, irregular-pair repair)."""

    def test_streaming_carried_state(self, ref, station_04s):
        """Per-block CDR with carried state: emitted bits AND the
        (pair, start, size) carry must match the reference exactly on
        identical real soft-symbol blocks."""
        from sdr_fm import get_mode_config
        from sdr_fm.golden import receiver as grx
        _, iq = station_04s
        mc = get_mode_config(0)
        outs = grx.run_file(iq, mc, stereo=True, with_rds=True)
        ours_st = grds.CdrState()
        ref_st = [np.zeros(2), 0, 0]
        n_checked = 0
        for b, o in enumerate(outs):
            sym = o.rds_symbols
            obits, ours_st = grds.cdr(sym, mc.rds.sps, ours_st, b)
            rbits, ref_st = ref.CDR(sym.copy(), mc.rds.sps, ref_st, b)
            np.testing.assert_array_equal(
                obits, np.asarray(rbits, dtype=np.int64),
                err_msg=f"block {b}")
            assert ours_st.start == ref_st[1]
            assert ours_st.prev_size == ref_st[2]
            np.testing.assert_allclose(ours_st.pair_prev, ref_st[0][0])
            n_checked += 1
        assert n_checked >= 10

    def test_noisy_synthetic_symbols(self, ref, rng):
        """Noisy RRC-shaped symbol streams (forcing irregular-pair repairs
        and grid restarts) at both RDS sample-per-symbol rates."""
        from sdr_fm.golden import filters as gfilt
        for sps in (26, 43):
            bits = rng.integers(0, 2, size=160)
            manch = np.stack([bits * 2 - 1, 1 - 2 * bits], -1).reshape(-1)
            x = np.zeros(len(manch) * sps)
            x[::sps] = manch
            rrc = gfilt.rrc_taps(2375.0 * sps, 101)
            soft = np.convolve(x, rrc, mode="same")
            soft /= np.abs(soft).max()
            soft += 0.15 * rng.standard_normal(len(soft))
            bs = len(soft) // 4
            ours_st = grds.CdrState()
            ref_st = [np.zeros(2), 0, 0]
            for b in range(4):
                blk = soft[b * bs:(b + 1) * bs]
                obits, ours_st = grds.cdr(blk, sps, ours_st, b)
                rbits, ref_st = ref.CDR(blk.copy(), sps, ref_st, b)
                np.testing.assert_array_equal(
                    obits, np.asarray(rbits, dtype=np.int64),
                    err_msg=f"sps {sps} block {b}")


class TestUpstreamStereoModel:
    """Execute /root/reference/model/stereo.py:152-281 itself and gate our
    golden stereo chain against its L/R output."""

    #: stereo.py predates the library's current fmPll (7-element state,
    #: model/fmSupportLib.py:322, and a 3-tuple return) — as checked in it
    #: crashes at its first PLL call (stereo.py:219).  These two shims are
    #: the minimal forward-port; they change no arithmetic.
    PATCHES = [("state_Pll=[0.0,0.0,1.0,0.0,1.0,0]",
                "state_Pll=[0.0,0.0,1.0,0.0,1.0,0,0.0]"),
               ("PLL, state_Pll = fmPll(",
                "PLL, _PLL_Q, state_Pll = fmPll(")]

    def test_stereo_lr_match(self, station_04s):
        import dataclasses

        from scipy import signal as spsig

        from sdr_fm import get_mode_config
        from sdr_fm.golden import receiver as grx
        base, iq = station_04s
        g = _exec_reference_script("/root/reference/model/stereo.py",
                                   ["stereo.py", "0"],
                                   base / "model_run", self.PATCHES)
        gl, gr = g["audio_data_left"], g["audio_data_right"]
        assert len(gl) > 10000

        mc = get_mode_config(0)
        coeffs = grx.design_coeffs(mc)
        # stereo.py designs its RF LPF with scipy firwin (stereo.py:90),
        # unlike every other entry point's impResponse; swap ours to the
        # same taps so the gate isolates CHAIN parity (coefficient-design
        # parity is covered by TestCoefficients)
        firwin_rf = spsig.firwin(151, 100e3 / (2.4e6 / 2), window="hann")
        cf = dataclasses.replace(coeffs, rf=firwin_rf)
        bs = 102400                               # stereo.py:116 mode 0

        def run(coeffs_):
            st = grx.init_state(mc)
            outs = []
            # ref loop: (count+1)*bs < len  (stereo.py:152)
            for b in range((len(iq) - 1) // bs):
                o, st = grx.process_block(iq[b * bs:(b + 1) * bs], coeffs_,
                                          st, mc, stereo=True,
                                          with_rds=False, block_count=b)
                outs.append(o)
            return (np.concatenate([o.left for o in outs]),
                    np.concatenate([o.right for o in outs]))

        left, right = run(cf)
        n = min(len(left), len(gl))
        assert n > 10000
        rms = lambda a, b: np.sqrt(np.mean((a[:n] - b[:n]) ** 2))
        # identical coefficients -> machine precision
        assert rms(left, gl) < 1e-9, rms(left, gl)
        assert rms(right, gr) < 1e-9, rms(right, gr)
        # our own RF design still meets the 1e-3 RMS output gate
        left2, right2 = run(coeffs)
        assert rms(left2, gl) < 1e-3, rms(left2, gl)
        assert rms(right2, gr) < 1e-3, rms(right2, gr)


class TestUpstreamRdsModel:
    """Execute /root/reference/model/fmRDS.py:198-310 itself, record its
    per-block RRC soft symbols and decoded bits via wrapped library
    functions, and gate our chain against both."""

    def test_rds_symbols_and_bitstream(self, station_04s):
        import importlib.util as ilu

        from sdr_fm import get_mode_config
        from sdr_fm.golden import receiver as grx
        base, iq = station_04s

        spec = ilu.spec_from_file_location(
            "fmSupportLib", "/root/reference/model/fmSupportLib.py")
        reflib = ilu.module_from_spec(spec)
        spec.loader.exec_module(reflib)
        rec = {"cdr_in": [], "diff_out": []}
        _cdr, _diff = reflib.CDR, reflib.diff_decoding

        def cdr_rec(x, sps, st, bc):
            rec["cdr_in"].append(np.array(x))
            return _cdr(x, sps, st, bc)

        def diff_rec(bits):
            out = _diff(bits)
            rec["diff_out"].append(np.array(out))
            return out

        reflib.CDR = cdr_rec
        reflib.diff_decoding = diff_rec
        saved = {k: sys.modules.get(k) for k in ("fmSupportLib",
                                                 "fmMonoBasic")}
        sys.modules["fmSupportLib"] = reflib
        sys.modules.pop("fmMonoBasic", None)
        try:
            _exec_reference_script("/root/reference/model/fmRDS.py",
                                   ["fmRDS.py", "0"], base / "model_run")
        finally:
            for k, v in saved.items():
                if v is None:
                    sys.modules.pop(k, None)
                else:
                    sys.modules[k] = v
        assert len(rec["cdr_in"]) >= 5

        mc = get_mode_config(0)
        coeffs = grx.design_coeffs(mc)
        state = grx.init_state(mc)
        bs = 2 * 10 * 5 * 960 * 2                 # fmRDS.py:152 mode 0
        our_syms = []
        for b in range((len(iq) - 1) // bs):
            o, state = grx.process_block(iq[b * bs:(b + 1) * bs], coeffs,
                                         state, mc, stereo=False,
                                         with_rds=True, block_count=b)
            our_syms.append(o.rds_symbols)
        assert len(our_syms) == len(rec["cdr_in"])

        # (a) per-block soft symbols at machine precision
        for b, (ours, theirs) in enumerate(zip(our_syms, rec["cdr_in"])):
            rms = np.sqrt(np.mean((ours - theirs) ** 2))
            assert rms < 1e-9, (b, rms)

        # (b) decoded bitstream EXACTLY equal, reproducing the script's
        # per-block fresh CDR state with start=158 (fmRDS.py:258-261)
        ours_bits = []
        for b, sym in enumerate(our_syms):
            st = grds.CdrState(pair_prev=0.0, start=158, prev_size=0)
            manch, st = grds.cdr(sym, mc.rds.sps, st, b)
            ours_bits.append(grds.diff_decode(manch))
        ours_bits = np.concatenate(ours_bits)
        ref_bits = np.concatenate(rec["diff_out"]).astype(np.int64)
        np.testing.assert_array_equal(ours_bits, ref_bits)
        # and the bitstream carries actual frames
        assert len(grds.frame_sync(ref_bits).matches) >= 4


class TestRdsDecode:
    def test_gf2_syndromes_match_matrixMult(self, ref, rng):
        bits = rng.integers(0, 2, size=26)
        ours = grds.gf2_syndrome(bits)
        theirs = ref.matrixMult(bits, grds.PARITY_MATRIX.tolist())
        np.testing.assert_array_equal(ours, theirs.astype(np.int64))

    def test_framesync_agrees_on_encoded_stream(self, ref):
        from sdr_fm.utils.synth import rds_encode_groups
        _, framed = rds_encode_groups(np.random.default_rng(5), 2)
        ours = grds.frame_sync(framed)
        offset, consumed = ref.framesync(framed)
        # the reference reports only the LAST matched offset, and its loop
        # bound (n < len-26) never examines the final complete block
        # (SURVEY.md §2.5) — compare against our last match before that
        in_their_range = [off for pos, off in ours.matches
                          if pos < len(framed) - 26]
        assert in_their_range[-1] == offset
        assert ours.matches[0][0] == 0  # stream starts on a block boundary
        # and ours additionally finds every block, including the last
        assert len(ours.matches) == len(framed) // 26

    def test_diff_and_manchester(self, ref, rng):
        soft = np.where(rng.integers(0, 2, size=200) > 0, 0.8, -0.8)
        ours = grds.manchester_decode(soft)
        theirs = np.asarray(ref.manchestering(soft), dtype=np.int64)
        np.testing.assert_array_equal(ours, theirs)
        bits = rng.integers(0, 2, size=64)
        np.testing.assert_array_equal(
            grds.diff_decode(bits),
            np.asarray(ref.diff_decoding(bits), dtype=np.int64))
