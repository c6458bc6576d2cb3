"""Where the program runs: kernel selection, the GPU check, the compile
cache."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from sdr_fm import config as cfg
from sdr_fm.models import receiver as rx
from sdr_fm.utils import runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestSelectKernels:
    def test_cpu_runs_plain_xla(self):
        """Off the GPU: the scan PLL and the convolution FIRs."""
        assert rx.select_kernels() == {"mxu_fir": False,
                                       "pll_kernel": False}

    def test_gpu_runs_kernel_and_matmuls(self, monkeypatch):
        """On the GPU both measured winners, at every channel count."""
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        assert rx.select_kernels() == {"mxu_fir": True, "pll_kernel": True}

    def test_block_fn_takes_selection_and_overrides(self, monkeypatch):
        """make_block_fn passes select_kernels' choice, and explicit
        selectors win over it."""
        seen = []

        def fake_step(iq, coeffs, state, mc, stereo, with_rds, rds_debug_q,
                      **sel):
            seen.append(sel)
            return None, state

        monkeypatch.setattr(rx, "_block_step", fake_step)
        monkeypatch.setattr(rx, "select_kernels",
                            lambda: {"mxu_fir": True, "pll_kernel": True})
        mc = cfg.get_mode_config(0)
        iq = np.zeros((3, 16), np.float32)
        rx.make_block_fn(mc)(iq, None, None)
        rx.make_block_fn(mc, pll_kernel=False)(iq[0], None, None)
        assert seen == [{"mxu_fir": True, "pll_kernel": True},
                        {"mxu_fir": True, "pll_kernel": False}]

    def test_sharded_paths_follow_the_selection(self, monkeypatch):
        """channel_sharded_run and time_sharded_receive compile the flags
        select_kernels returns, like a one-device run."""
        from jax.sharding import Mesh

        from sdr_fm.parallel import channel, time_shard
        seen = set()
        real = rx.process_block

        def spy(*a, **kw):
            seen.add((kw["mxu_fir"], kw["pll_kernel"]))
            return real(*a, **kw)

        monkeypatch.setattr(rx, "process_block", spy)
        monkeypatch.setattr(rx, "select_kernels",
                            lambda: {"mxu_fir": True, "pll_kernel": False})
        mc = cfg.get_mode_config(0)
        rng = np.random.default_rng(0)
        iq = rng.integers(0, 256, (8, mc.default_block_size()),
                          dtype=np.uint8)
        channel.channel_sharded_run(
            iq, Mesh(np.array(jax.devices()[:8]), ("ch",)), 0, stereo=False)
        assert seen == {(True, False)}
        seen.clear()
        block_raw = time_shard.default_block_if(mc) * 2 * mc.rf_decim
        time_shard.time_sharded_receive(
            rng.uniform(-1, 1, 4 * block_raw).astype(np.float32),
            Mesh(np.array(jax.devices()[:2]), ("time",)), 0, stereo=False)
        assert seen == {(True, False)}


class TestGpuCheck:
    def test_require_gpu_refuses_cpu(self):
        with pytest.raises(RuntimeError, match="no GPU"):
            runtime.require_gpu()

    def test_bench_refuses_cpu(self):
        """The benchmark fails instead of timing the CPU."""
        sys.path.insert(0, REPO)
        import bench
        with pytest.raises(RuntimeError, match="no GPU"):
            bench.main()


class TestCompileCache:
    def test_env_dir_is_used_and_nothing_else_set(self, monkeypatch,
                                                  tmp_path):
        calls = []
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        monkeypatch.setattr(jax.config, "update",
                            lambda *a: calls.append(a))
        assert runtime.enable_compile_cache() == str(tmp_path)
        assert calls == []

    def test_default_is_checkout_dir(self, monkeypatch):
        calls = []
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        monkeypatch.setattr(jax.config, "update",
                            lambda *a: calls.append(a))
        path = runtime.enable_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert calls == [("jax_compilation_cache_dir", path)]

    def test_same_path_from_every_process(self, tmp_path):
        """The path is fixed (it is part of the cache key): two processes
        started from different directories agree."""
        env = {k: v for k, v in os.environ.items()
               if k != "JAX_COMPILATION_CACHE_DIR"}
        env["PYTHONPATH"] = REPO
        code = ("from sdr_fm.utils.runtime import compile_cache_dir; "
                "print(compile_cache_dir())")
        outs = {subprocess.run([sys.executable, "-c", code], cwd=cwd,
                               env=env, capture_output=True, text=True,
                               check=True).stdout.strip()
                for cwd in (REPO, str(tmp_path))}
        assert outs == {os.path.join(REPO, ".jax_cache")}

    def test_default_dir_is_gitignored(self):
        with open(os.path.join(REPO, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()
