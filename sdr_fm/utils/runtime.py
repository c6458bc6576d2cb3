"""Where the program runs: the GPU check and the compile cache.

Measurement entry points (bench.py, chip_smoke.py) call ``require_gpu``:
a run that finds no GPU fails instead of timing another device.  The CLI
runs wherever JAX runs (``JAX_PLATFORMS=cpu`` is an explicit choice).
"""

from __future__ import annotations

import os
import subprocess

#: root of the checkout this package was imported from
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


def compile_cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else ``<checkout>/.jax_cache``
    (a fixed path: the directory is part of the cache key)."""
    return os.environ.get(_CACHE_ENV) or os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache; returns its directory.

    With ``JAX_COMPILATION_CACHE_DIR`` set, JAX already uses it and no
    other directory is set here."""
    import jax
    path = compile_cache_dir()
    if not os.environ.get(_CACHE_ENV):
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu() -> list:
    """All JAX devices, when every one is a GPU; raises otherwise."""
    import jax
    devs = jax.devices()
    others = sorted({d.platform for d in devs if d.platform != "gpu"})
    if others:
        raise RuntimeError(f"no GPU: JAX runs on {', '.join(others)}")
    return devs


def card_info() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
