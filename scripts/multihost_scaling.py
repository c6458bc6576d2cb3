"""Multi-host scaling measurement for the channel axis (SURVEY.md §2.3).

The reference scales across cores with two pthreads and a bounded queue
(src/project.cpp); this framework's scale-out story is a jax.distributed
mesh whose **channel** axis spans processes while the **time** axis stays
inside each process's devices (parallel/multihost.py).  This script
*measures* that story on CPU devices: it launches N real OS processes, each
a jax.distributed participant with its own CPU device(s), pins each to a
dedicated core (weak scaling: per-process work constant), and times the
channel-sharded receiver (parallel/channel.py semantics) over the global
mesh.

Why this is an honest cross-process measurement: the processes
communicate through the same jax.distributed/XLA cross-process machinery
a multi-host deployment uses (gRPC coordination, cross-process
collectives); the channel axis has ZERO collectives on the hot path, so
scaling efficiency is 1 minus the coordination overhead.

Usage:
    python scripts/multihost_scaling.py [--out F]  # orchestrate, print (write F)
    python scripts/multihost_scaling.py --worker … # internal

The host has few cores; configurations needing more processes than cores
are still run (functional validation of the >2-process mesh) but marked
``oversubscribed`` and excluded from the efficiency gate.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# per-process workload: C channels of mode-0 FM, B blocks
CH_PER_PROC = int(os.environ.get("SDR_SCALING_CH", "4"))
N_BLOCKS = int(os.environ.get("SDR_SCALING_BLOCKS", "24"))
TIMED_REPS = int(os.environ.get("SDR_SCALING_REPS", "4"))
N_ROUNDS = int(os.environ.get("SDR_SCALING_ROUNDS", "8"))


def worker_main(a: argparse.Namespace) -> None:
    # the multi-process harness runs on CPU devices on purpose; the config
    # route wins because the backend is not yet initialized
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", a.local_devices)
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{a.port}",
        num_processes=a.num_processes, process_id=a.process_id)

    import jax.numpy as jnp
    import numpy as np
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding, PartitionSpec as P

    from sdr_fm import config as cfg
    from sdr_fm.models import receiver as rx
    from sdr_fm.parallel import multihost

    mesh = multihost.make_mesh(time_per_host=a.local_devices)
    grid = np.asarray(mesh.devices)
    # The scaling-critical layout invariant: every time-axis row lives on
    # ONE process, so the time-shard halo ppermute never crosses DCN.
    halo_local = all(len({d.process_index for d in row}) == 1
                     for row in grid)

    mc = cfg.get_mode_config(0)
    bs = mc.default_block_size(False)
    c_local = a.ch_per_proc
    c_global = c_local * a.num_processes

    # Each process synthesizes only ITS channels (seeded by process id) —
    # on a real deployment each host ingests its own SDR front-ends.
    # RAW u8 end to end (r5, matching the serving path): the receiver
    # normalizes on-device, so per-block host/distribution bytes are a
    # quarter of a float feed's.
    rng = np.random.default_rng(1000 + a.process_id)
    local_blocks = rng.integers(
        0, 256, size=(N_BLOCKS, c_local, bs), dtype=np.uint8)

    iq_sh = NamedSharding(mesh, P(None, "ch", None))
    iq_dev = jax.make_array_from_process_local_data(iq_sh, local_blocks)

    coeffs = jax.tree.map(
        lambda x: jax.make_array_from_process_local_data(
            NamedSharding(mesh, P()), np.asarray(x)),
        rx.design_coeffs(mc))
    state = jax.tree.map(
        lambda x: jax.make_array_from_process_local_data(
            NamedSharding(mesh, P("ch")), np.asarray(x)),
        rx.init_state(mc, batch_shape=(c_local,)))

    def run_once(st):
        outs, st = rx.run_blocks_scan(iq_dev, coeffs, st, 0, True, False)
        jax.block_until_ready(outs)
        return st

    st = run_once(state)  # compile + warmup
    # One global barrier so all processes enter the timed region together,
    # then NO barriers inside it: the channel axis has zero collectives on
    # the hot path, so per-round timing is local — a barrier per round
    # would bias the multi-process configs up by the straggler effect
    # (min over rounds of max-over-procs ≥ max over procs of min) even at
    # zero true overhead.  Each process reports its own best-round local
    # throughput; the orchestrator sums them (all concurrent by the
    # barrier), which is methodologically identical to the independent-
    # process control.
    multihost_utils.sync_global_devices("start")
    dt = float("inf")
    for _ in range(N_ROUNDS):
        t0 = time.perf_counter()
        for _ in range(TIMED_REPS):
            st = run_once(st)
        dt = min(dt, time.perf_counter() - t0)
    multihost_utils.sync_global_devices("end")

    # interleaved I/Q: bs values = bs/2 complex RF samples per channel-block
    # — LOCAL work only; the orchestrator sums per-process throughputs
    samples = TIMED_REPS * N_BLOCKS * (bs // 2) * c_local
    out = {
        "process_id": a.process_id,
        "num_processes": a.num_processes,
        "local_devices": a.local_devices,
        "global_devices": int(jax.device_count()),
        "channels_global": c_global,
        "wall_s": dt,
        "samples_per_s": samples / dt,
        "halo_confined_to_host": bool(halo_local),
    }
    with open(os.path.join(a.outdir, f"result_{a.process_id}.json"),
              "w") as f:
        json.dump(out, f)


def worker_time_axis(a: argparse.Namespace) -> None:
    """TIME-axis worker: run the time-sharded receiver
    under real ``jax.distributed`` on a 2D (ch x time) mesh where the
    time axis spans each process's LOCAL devices — proving the halo
    ppermute stays intra-process (on a pod: intra-ICI) — and gate the
    sharded outputs against a contiguous run of the same channel."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", a.local_devices)
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{a.port}",
        num_processes=a.num_processes, process_id=a.process_id)

    import numpy as np
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding, PartitionSpec as P

    from sdr_fm import config as cfg
    from sdr_fm.models import receiver as rx
    from sdr_fm.parallel import multihost, time_shard

    mesh = multihost.make_mesh(time_per_host=a.local_devices,
                               cross_process_time=a.cross_halo)
    grid = np.asarray(mesh.devices)          # (ch, time)
    # default: every time-axis row lives on ONE process, so halo
    # ppermutes never cross the process (DCN) boundary.  --cross-halo
    # transposes the grid so every halo ppermute DOES cross it — the
    # configuration the policy avoids, validated here for correctness
    # and costed against the local-halo layout.
    halo_intra_process = all(len({d.process_index for d in row}) == 1
                             for row in grid)

    mc = cfg.get_mode_config(0)
    block_if = time_shard.default_block_if(mc, False)
    raw_per_if = 2 * mc.rf_decim
    s_time = mesh.shape["time"]
    blocks_per_shard = 6
    n = s_time * blocks_per_shard * block_if * raw_per_if

    if a.cross_halo:
        # time spans the processes: each process holds EVERY channel row
        # and its own time half, so the channel streams must be globally
        # consistent — generate from a SHARED seed and slice this
        # process's time window (process p owns time column p of the
        # transposed grid)
        n_ch = int(mesh.shape["ch"])
        rng = np.random.default_rng(2000)
        full = (rng.integers(0, 256, size=(n_ch, n), dtype=np.uint8)
                .astype(np.float32) / 128.0 - 1.0)
        span = n // a.num_processes
        local = full[:, a.process_id * span:(a.process_id + 1) * span]
    else:
        rng = np.random.default_rng(2000 + a.process_id)
        local = (rng.integers(0, 256, size=(1, n), dtype=np.uint8)
                 .astype(np.float32) / 128.0 - 1.0)
        full = local
    sharding = NamedSharding(mesh, P("ch", "time"))
    iq_global = jax.make_array_from_process_local_data(sharding, local)

    def run_once():
        out = time_shard.time_sharded_receive(
            iq_global, mesh, 0, stereo=True, batch_axis="ch",
            block_if=block_if)
        jax.block_until_ready(out.mono)
        return out

    out = run_once()   # compile + warmup
    multihost_utils.sync_global_devices("start")
    dt = float("inf")
    for _ in range(N_ROUNDS):
        t0 = time.perf_counter()
        out = run_once()
        dt = min(dt, time.perf_counter() - t0)
    multihost_utils.sync_global_devices("end")

    # correctness: this process's row vs a contiguous local run
    mono_g = multihost_utils.process_allgather(out.mono, tiled=True)
    fm_g = multihost_utils.process_allgather(out.fm_demod, tiled=True)
    import jax.numpy as jnp
    # global channel row this process validates: in the default layout
    # each process contributed row process_id (its local[0]); in cross
    # mode the rows are the shared-seed channels, validate row process_id
    # of those (every process has the full series in `full`)
    row = a.process_id
    ref_src = full[row] if a.cross_halo else full[0]
    rxr = rx.Receiver(0, stereo=True, with_rds=False)
    ref = rxr.run(ref_src, block_size=block_if * raw_per_if)
    ref_mono = np.asarray(ref.mono).reshape(-1)
    ref_fm = np.asarray(ref.fm_demod).reshape(-1)
    fm_err = float(np.abs(fm_g[row] - ref_fm).max())
    d = np.abs(mono_g[row] - ref_mono)
    mono_rel = float(np.sqrt((d ** 2).mean())
                     / max(np.sqrt((ref_mono ** 2).mean()), 1e-30))

    samples = (n // 2) * 1  # complex IQ pairs, one channel per process
    result = {
        "process_id": a.process_id,
        "num_processes": a.num_processes,
        "local_devices": a.local_devices,
        "global_devices": int(jax.device_count()),
        "mesh_shape": {k: int(v) for k, v in mesh.shape.items()},
        "halo_intra_process": bool(halo_intra_process),
        "cross_halo_requested": bool(a.cross_halo),
        "wall_s": dt,
        "samples_per_s": samples / dt,
        "fm_max_abs_err_vs_contiguous": fm_err,
        "mono_rel_rms_vs_contiguous": mono_rel,
    }
    with open(os.path.join(a.outdir, f"result_{a.process_id}.json"),
              "w") as f:
        json.dump(result, f)


def _run_time_axis(n_procs: int, local_devices: int, ncores: int,
                   timeout_s: float = 900.0, cross: bool = False) -> dict:
    port = _free_port()
    outdir = tempfile.mkdtemp(prefix="sdr_scaling_time_")
    procs = []
    for pid in range(n_procs):
        cmd = [sys.executable, os.path.abspath(__file__), "--worker",
               "--axis", "time", "--port", str(port),
               "--num-processes", str(n_procs), "--process-id", str(pid),
               "--local-devices", str(local_devices), "--outdir", outdir]
        if cross:
            cmd.append("--cross-halo")
        procs.append(subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    deadline = time.time() + timeout_s
    for p in procs:
        try:
            p.wait(timeout=max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise RuntimeError("time-axis config timed out")
    for p in procs:
        if p.returncode != 0:
            raise RuntimeError(
                f"time-axis worker failed:\n{p.stderr.read()}")
    results = []
    for pid in range(n_procs):
        with open(os.path.join(outdir, f"result_{pid}.json")) as f:
            results.append(json.load(f))
    return {
        "num_processes": n_procs,
        "local_devices_per_process": local_devices,
        "cross_halo": cross,
        "mesh_shape": results[0]["mesh_shape"],
        "halo_intra_process": all(r["halo_intra_process"]
                                  for r in results),
        "wall_s": max(r["wall_s"] for r in results),
        "aggregate_samples_per_s": sum(r["samples_per_s"]
                                       for r in results),
        "fm_max_abs_err_vs_contiguous": max(
            r["fm_max_abs_err_vs_contiguous"] for r in results),
        "mono_rel_rms_vs_contiguous": max(
            r["mono_rel_rms_vs_contiguous"] for r in results),
        "oversubscribed": n_procs * local_devices > ncores,
    }


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_config(n_procs: int, local_devices: int, ncores: int,
                timeout_s: float = 600.0) -> dict:
    port = _free_port()
    outdir = tempfile.mkdtemp(prefix=f"sdr_scaling_{n_procs}p_")
    procs = []
    have_taskset = shutil.which("taskset") is not None
    for pid in range(n_procs):
        cmd = []
        if have_taskset:
            cmd += ["taskset", "-c", str(pid % ncores)]
        cmd += [sys.executable, os.path.abspath(__file__), "--worker",
                "--port", str(port), "--num-processes", str(n_procs),
                "--process-id", str(pid), "--local-devices",
                str(local_devices), "--ch-per-proc", str(CH_PER_PROC),
                "--outdir", outdir]
        procs.append(subprocess.Popen(
            cmd, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    deadline = time.time() + timeout_s
    for p in procs:
        try:
            p.wait(timeout=max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            for q in procs:   # kill the exact PIDs we spawned, never a pattern
                q.kill()
            raise RuntimeError(f"{n_procs}-process config timed out")
    for p in procs:
        if p.returncode != 0:
            raise RuntimeError(
                f"worker failed (rc={p.returncode}):\n{p.stderr.read()}")
    results = []
    for pid in range(n_procs):
        with open(os.path.join(outdir, f"result_{pid}.json")) as f:
            results.append(json.load(f))
    # aggregate = sum of concurrent per-process local throughputs (same
    # methodology as the independent-process control)
    wall = max(r["wall_s"] for r in results)
    agg = sum(r["samples_per_s"] for r in results)
    return {
        "num_processes": n_procs,
        "local_devices_per_process": local_devices,
        "global_devices": results[0]["global_devices"],
        "channels_global": results[0]["channels_global"],
        "wall_s": wall,
        "aggregate_samples_per_s": agg,
        "halo_confined_to_host": all(r["halo_confined_to_host"]
                                     for r in results),
        "oversubscribed": n_procs * max(1, local_devices) > ncores,
        "pinned": have_taskset,
    }


def _run_control(ncores: int, timeout_s: float = 600.0) -> dict:
    """Two INDEPENDENT 1-process workers running concurrently on separate
    cores (no shared jax.distributed runtime): the control that separates
    the host's shared memory-bandwidth ceiling from distributed-runtime
    overhead.  On a real pod each host has its own HBM, so the DCN-regime
    efficiency is distributed / control."""
    jobs = []
    have_taskset = shutil.which("taskset") is not None
    for i in range(2):
        port = _free_port()
        outdir = tempfile.mkdtemp(prefix=f"sdr_scaling_ctl{i}_")
        cmd = (["taskset", "-c", str(i % ncores)] if have_taskset else [])
        cmd += [sys.executable, os.path.abspath(__file__), "--worker",
                "--port", str(port), "--num-processes", "1",
                "--process-id", "0", "--local-devices", "1",
                "--ch-per-proc", str(CH_PER_PROC), "--outdir", outdir]
        jobs.append((subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True),
                     outdir))
    deadline = time.time() + timeout_s
    results = []
    for p, outdir in jobs:
        try:
            p.wait(timeout=max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            for q, _ in jobs:
                q.kill()
            raise RuntimeError("control config timed out")
        if p.returncode != 0:
            raise RuntimeError(f"control worker failed:\n{p.stderr.read()}")
        with open(os.path.join(outdir, "result_0.json")) as f:
            results.append(json.load(f))
    return {
        "aggregate_samples_per_s": sum(r["samples_per_s"]
                                       for r in results),
        "per_proc_samples_per_s": [r["samples_per_s"] for r in results],
    }


def orchestrate() -> dict:
    ncores = os.cpu_count() or 1
    report: dict = {
        "what": "weak scaling of the channel axis over jax.distributed "
                "processes (DCN regime), 1 pinned core per process",
        "host_cores": ncores,
        "ch_per_process": CH_PER_PROC,
        "configs": [],
    }
    # this host's timing is noisy (virtualized, shared): take the best of
    # config-level repeats — max throughput measures the machine, and an
    # UNDER-measured 1-proc baseline would otherwise inflate efficiency
    repeats = int(os.environ.get("SDR_SCALING_REPEATS", "3"))
    for n in (1, 2, 4):
        print(f"[scaling] running {n}-process config x{repeats} ...",
              flush=True)
        r = max((_run_config(n, local_devices=1, ncores=ncores)
                 for _ in range(repeats)),
                key=lambda x: x["aggregate_samples_per_s"])
        report["configs"].append(r)
        print(f"[scaling]   {r['aggregate_samples_per_s']/1e6:.2f} MS/s "
              f"aggregate, wall {r['wall_s']:.2f}s"
              f"{' (oversubscribed)' if r['oversubscribed'] else ''}",
              flush=True)
    print("[scaling] running 2-independent-process control ...", flush=True)
    ctl = max((_run_control(ncores) for _ in range(repeats)),
              key=lambda x: x["aggregate_samples_per_s"])
    report["control_2_independent"] = ctl
    base = report["configs"][0]["aggregate_samples_per_s"]
    for r in report["configs"]:
        n = r["num_processes"]
        r["scaling_efficiency_vs_1proc"] = (
            r["aggregate_samples_per_s"] / (n * base))
        # per-core efficiency stays meaningful when procs > cores
        eff_cores = min(n, ncores)
        r["per_core_efficiency"] = (
            r["aggregate_samples_per_s"] / (eff_cores * base))
    # DCN-regime efficiency: distributed 2-proc vs two independent procs
    # on the same cores — isolates jax.distributed/collective-runtime
    # overhead from the host's shared memory-bandwidth ceiling (absent on
    # a pod, where each host owns its HBM)
    two = next(r for r in report["configs"] if r["num_processes"] == 2)
    two["dcn_efficiency_vs_independent"] = (
        two["aggregate_samples_per_s"] / ctl["aggregate_samples_per_s"])
    gated = [r for r in report["configs"]
             if not r["oversubscribed"] and r["num_processes"] > 1]
    report["gated_configs"] = [r["num_processes"] for r in gated]
    # HONEST gating: the north-star 95% target is the RAW
    # scaling efficiency vs 1 process; the contention-CONTROLLED number
    # (distributed vs two independent processes on the same cores) is
    # reported alongside, never substituted into the headline gate.
    report["gate_95pct_met_raw"] = all(
        r["scaling_efficiency_vs_1proc"] >= 0.95 for r in gated)
    report["gate_95pct_met_controlled"] = all(
        r.get("dcn_efficiency_vs_independent",
              r["scaling_efficiency_vs_1proc"]) >= 0.95 for r in gated)
    report["gate_95pct_met"] = report["gate_95pct_met_raw"]
    if (not report["gate_95pct_met_raw"]
            and report["gate_95pct_met_controlled"]):
        report["host_limitation"] = (
            f"raw scaling efficiency misses 0.95 on this {ncores}-core "
            "shared-memory host: concurrent processes contend for one "
            "memory system, which a multi-host pod (per-host HBM) does "
            "not; the controlled comparison vs two INDEPENDENT processes "
            "on the same cores isolates jax.distributed overhead and "
            "passes, but the raw north-star number on this environment "
            "does not — reported as such")
    # 2-process × 2-local-device config: validates the 2D (ch × time) mesh
    # across processes with the halo confined per host (functional, unpinned
    # timing — 4 devices on ncores cores).
    print("[scaling] running 2-process x 2-device 2D-mesh config ...",
          flush=True)
    report["mesh2d_2proc_2dev"] = _run_config(2, local_devices=2,
                                              ncores=ncores)
    # 2-process TIME-axis config: the time-sharded
    # receiver itself under jax.distributed, halo ppermute provably
    # intra-process, outputs gated against a contiguous run.
    print("[scaling] running 2-process TIME-axis config ...", flush=True)
    report["time_axis_2proc"] = _run_time_axis(2, local_devices=2,
                                               ncores=ncores)
    # cross-process halo: the SAME time-sharded receiver
    # with the mesh transposed so every halo ppermute crosses the process
    # boundary — correctness gated identically (fm bit-match), and its
    # wall vs the local-halo config is the measured cost that justifies
    # the "halo stays on ICI" layout policy.
    print("[scaling] running 2-process CROSS-process-halo config ...",
          flush=True)
    report["time_axis_2proc_cross_halo"] = _run_time_axis(
        2, local_devices=2, ncores=ncores, cross=True)
    loc, cro = (report["time_axis_2proc"],
                report["time_axis_2proc_cross_halo"])
    report["cross_halo_slowdown"] = round(
        cro["wall_s"] / max(loc["wall_s"], 1e-12), 3)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--port", type=int)
    ap.add_argument("--num-processes", type=int, dest="num_processes")
    ap.add_argument("--process-id", type=int, dest="process_id")
    ap.add_argument("--local-devices", type=int, default=1,
                    dest="local_devices")
    ap.add_argument("--ch-per-proc", type=int, default=CH_PER_PROC,
                    dest="ch_per_proc")
    ap.add_argument("--outdir")
    ap.add_argument("--axis", default="ch", choices=["ch", "time"])
    ap.add_argument("--cross-halo", action="store_true", dest="cross_halo")
    ap.add_argument("--out", help="also write the report to this JSON file")
    a = ap.parse_args(argv)
    if a.worker:
        if a.axis == "time":
            worker_time_axis(a)
        else:
            worker_main(a)
        return 0
    report = orchestrate()
    if a.out:
        with open(a.out, "w") as f:
            json.dump(report, f, indent=2)
    print(json.dumps({k: v for k, v in report.items() if k != "configs"},
                     indent=2))
    for r in report["configs"]:
        print(f"  n={r['num_processes']}: "
              f"{r['aggregate_samples_per_s']/1e6:.2f} MS/s, "
              f"eff={r['scaling_efficiency_vs_1proc']:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
