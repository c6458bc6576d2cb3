"""Command-line receiver: u8 IQ in -> PCM/wav/RDS out.

Replaces the reference's positional-argv entry points
(``./project <mode 0-3> <channels 1|2>``, src/project.cpp:385-419;
``python3 stereo.py <mode>``) with one typed CLI over the JAX receiver:

    python -m sdr_fm.cli --mode 0 --stereo capture.raw -o out.pcm
    rtl_sdr -f 99.9M -s 2.4M - | python -m sdr_fm.cli --mode 0 - | aplay ...

Streaming uses the jitted per-block step with carried state (the same
program bench.py measures); ``--wav`` writes a .wav instead of raw PCM and
``--rds`` prints decoded RDS frame info to stderr.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from sdr_fm import config as cfg
from sdr_fm import io as sio


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sdr_fm", description="FM receiver on JAX")
    p.add_argument("input", help="raw interleaved u8 IQ file, or '-' "
                                 "for stdin")
    p.add_argument("--mode", type=int, default=0, choices=[0, 1, 2, 3],
                   help="sample-rate mode (group-28 constraint table)")
    p.add_argument("--stereo", action="store_true",
                   help="decode stereo (default mono)")
    p.add_argument("--rds", action="store_true",
                   help="decode RDS frames (modes 0/2 only)")
    p.add_argument("--rds-algo", default="robust",
                   choices=["robust", "reference", "tracking"],
                   help="RDS symbol-clock recovery: restart-free "
                        "phase/parity estimation (robust, default), the "
                        "reference-faithful CDR (reference), or windowed "
                        "re-estimation for drifting transmit clocks "
                        "(tracking)")
    p.add_argument("-o", "--output", default="-",
                   help="PCM output path, '-' for stdout")
    p.add_argument("--wav", action="store_true",
                   help="write a .wav file instead of raw PCM")
    p.add_argument("--block-size", type=int, default=None,
                   help="raw u8 samples per block (default per-mode)")
    p.add_argument("--stats", action="store_true",
                   help="print throughput stats and the device to stderr "
                        "at EOF")
    p.add_argument("--inflight", type=int,
                   default=int(os.environ.get("SDR_FM_CLI_INFLIGHT", "8")),
                   help="blocks in flight on the device->host fetch "
                        "pipeline (overlaps fetches with device compute; "
                        "raises audio latency by inflight blocks)")
    p.add_argument("--save-state", metavar="PATH",
                   help="checkpoint receiver state to PATH (.npz) at EOF")
    p.add_argument("--resume", metavar="PATH",
                   help="resume from a state checkpoint (.npz)")
    p.add_argument("--wideband", metavar="FS",
                   help="input is a wideband capture at FS samples/s: "
                        "channelize --offsets stations and decode them as "
                        "one batch (requires --wav -o PREFIX)")
    p.add_argument("--offsets", metavar="HZ,HZ,...",
                   help="comma-separated station offsets for --wideband")
    return p


def _warn_algo_mismatch(rds_meta: dict, requested: str) -> None:
    """A checkpoint pins its RDS algorithm (the carry layouts differ);
    surface the conflict instead of silently ignoring --rds-algo."""
    stored = rds_meta.get("algo")
    if stored and stored != requested:
        print(f"warning: --rds-algo {requested} ignored - checkpoint "
              f"was created with '{stored}' and resume continues with it",
              file=sys.stderr)


def _main_wideband(args) -> int:
    """Wideband serving path: channelize + batched receive, one wav per
    station (out path PREFIX_<k>.wav), RDS per station on stderr.

    Fully streaming: per-block incremental wav writes
    (io.StreamingWavWriter seekable-header technique), per-station
    StreamingRdsDecoder fed each block, and ``--save-state``/``--resume``
    covering the channelizer carry + the batched receiver pytree + every
    station's RDS carry — host memory stays O(block) however long the
    capture, and a resumed run's frame stream is identical to the
    uninterrupted one (tests/test_wideband_streaming.py).
    """
    import jax.numpy as jnp

    from sdr_fm.models import rds_decode
    from sdr_fm.models import receiver as rx
    from sdr_fm.models.channelizer import Channelizer, ChannelizerState

    if not args.offsets or not args.wav or args.output == "-":
        print("--wideband needs --offsets HZ,HZ,... and --wav -o PREFIX",
              file=sys.stderr)
        return 2
    offsets = [float(f) for f in args.offsets.split(",")]
    mc = cfg.get_mode_config(args.mode)
    with_rds = args.rds and mc.rds is not None
    if args.rds and mc.rds is None:
        print(f"mode {args.mode} carries no RDS; ignoring --rds",
              file=sys.stderr)
    ch = Channelizer(offsets, float(args.wideband), args.mode)
    receiver = rx.Receiver(args.mode, stereo=args.stereo, with_rds=with_rds,
                           batch_shape=(len(offsets),))
    bs_wide = (args.block_size
               or mc.default_block_size(with_rds)) * ch.decim

    rds_decs = ([rds_decode.StreamingRdsDecoder(mc.rds.sps, args.rds_algo)
                 for _ in offsets] if with_rds else None)
    block_count = 0
    if args.resume:
        from sdr_fm import checkpoint
        # the wideband receiver is fed channelized float baseband, not u8
        receiver.state, meta = checkpoint.load(args.resume,
                                               expect_input_dtype="float32")
        block_count = meta.get("block_count", 0)
        ha = meta["host_arrays"]
        ch.state = ChannelizerState(fir=jnp.asarray(ha["chan/fir"]),
                                    phi0=jnp.asarray(ha["chan/phi0"]))
        if with_rds and "rds_per_station" in meta.get("extra", {}):
            rds_decs = []
            for k, rmeta in enumerate(meta["extra"]["rds_per_station"]):
                _warn_algo_mismatch(rmeta, args.rds_algo)
                rds_decs.append(rds_decode.StreamingRdsDecoder.
                                load_state_dict(
                                    {key[len(f"rds{k}/"):]: v
                                     for key, v in ha.items()
                                     if key.startswith(f"rds{k}/")}, rmeta))
        print(f"resumed from {args.resume} at block {block_count}",
              file=sys.stderr)

    in_stream = sio.stdin_binary() if args.input == "-" else open(
        args.input, "rb")
    writers = [sio.StreamingWavWriter(f"{args.output}_{k}.wav", mc.audio_fs,
                                      channels=2 if args.stereo else 1)
               for k in range(len(offsets))]
    import jax.numpy as jnp
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    # same packed-single-fetch + in-order fetch pipeline as the single-
    # station path: outputs for ALL stations ride one transfer
    def pack(out):
        parts = ([out.left, out.right] if args.stereo else [out.mono])
        if with_rds:
            parts.append(out.rds_symbols)
        return jnp.concatenate(parts, axis=-1)

    sym_len = 0

    def emit(flat: np.ndarray) -> None:
        if args.stereo:
            n_a = (flat.shape[-1] - sym_len) // 2
            audio = np.stack([flat[..., :n_a], flat[..., n_a:2 * n_a]],
                             axis=-1)
            rest = flat[..., 2 * n_a:]
        else:
            n_a = flat.shape[-1] - sym_len
            audio, rest = flat[..., :n_a], flat[..., n_a:]
        for k, w in enumerate(writers):
            w.write(audio[k])
        if with_rds:
            for k, dec in enumerate(rds_decs):
                dec.feed(rest[k])

    depth = max(1, args.inflight)
    pool = ThreadPoolExecutor(max_workers=max(2, depth // 2))
    pending: deque = deque()
    n_blocks = 0
    t0 = time.time()
    try:
        while True:
            raw = in_stream.read(bs_wide)
            if raw is None or len(raw) < bs_wide:
                break
            out = receiver.process(
                ch.process(np.frombuffer(raw, dtype=np.uint8)))
            if with_rds and not sym_len:
                sym_len = int(out.rds_symbols.shape[-1])
            pending.append(pool.submit(np.asarray, pack(out)))
            n_blocks += 1
            while len(pending) >= depth:
                emit(pending.popleft().result())
        while pending:
            emit(pending.popleft().result())
    finally:
        try:
            while pending:
                emit(pending.popleft().result(timeout=30))
        except Exception:
            pass
        pool.shutdown(wait=False)
        if in_stream is not sys.stdin.buffer:
            in_stream.close()
        for w in writers:
            w.close()
    dt = time.time() - t0
    if with_rds and not args.save_state:
        for dec in rds_decs:
            dec.flush()

    if n_blocks == 0 and not args.resume:
        print(f"input shorter than one wideband block ({bs_wide} samples); "
              "nothing decoded", file=sys.stderr)
        return 1

    if args.save_state:
        from sdr_fm import checkpoint
        host_arrays = {"chan/fir": np.asarray(ch.state.fir),
                       "chan/phi0": np.asarray(ch.state.phi0)}
        extra = {"wideband": {"fs": ch.fs_wide, "offsets": list(offsets)}}
        if with_rds:
            extra["rds_per_station"] = []
            for k, dec in enumerate(rds_decs):
                arrays, rmeta = dec.state_dict()
                extra["rds_per_station"].append(rmeta)
                host_arrays.update({f"rds{k}/{key}": v
                                    for key, v in arrays.items()})
        written = checkpoint.save(args.save_state, receiver.state,
                                  args.mode,
                                  block_count=block_count + n_blocks,
                                  extra=extra, host_arrays=host_arrays,
                                  input_dtype="float32")
        print(f"state saved to {written} "
              f"(block {block_count + n_blocks})", file=sys.stderr)

    for k, f_off in enumerate(offsets):
        msg = (f"station {k} @ {f_off / 1e6:+.2f} MHz -> "
               f"{args.output}_{k}.wav")
        if with_rds:
            dec = rds_decs[k]
            msg += f" | RDS {dec.n_matches} frames"
            if dec.n_corrected:
                msg += f" ({dec.n_corrected} corrected)"
            st = dec.station_info()
            if st.n_groups and st.pi is not None:
                msg += f" PI={st.pi:04X} PS={st.ps_name!r}"
        print(msg, file=sys.stderr)
    if args.stats:
        pairs = n_blocks * bs_wide / 2
        print(f"{n_blocks} wideband blocks, {len(offsets)} stations, "
              f"{pairs / 1e6:.2f} M IQ pairs in {dt:.2f}s = "
              f"{pairs / dt / 1e6:.1f} MS/s on {_device_label()}",
              file=sys.stderr)
    return 0


def _device_label() -> str:
    """Platform and kind of the device the receiver ran on."""
    import jax
    d = jax.devices()[0]
    return f"{d.platform} ({d.device_kind})"


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from sdr_fm.utils.runtime import enable_compile_cache
    enable_compile_cache()

    from sdr_fm.models import receiver as rx
    from sdr_fm.models import rds_decode, rds_groups

    if args.wideband:
        return _main_wideband(args)

    mc = cfg.get_mode_config(args.mode)
    if args.wav and args.output == "-":
        print("--wav needs an output file: pass -o PATH", file=sys.stderr)
        return 2
    with_rds = args.rds and mc.rds is not None
    if args.rds and mc.rds is None:
        print(f"mode {args.mode} carries no RDS; ignoring --rds",
              file=sys.stderr)
    bs = args.block_size or mc.default_block_size(with_rds)

    receiver = rx.Receiver(args.mode, stereo=args.stereo, with_rds=with_rds)
    # streaming host-side RDS decode with carried state: CDR carry + bit
    # backlog + pending frames, O(block) host memory however long the run
    # (the reference's per-block decode loop, model/fmRDS.py:256-278)
    rds_dec = (rds_decode.StreamingRdsDecoder(mc.rds.sps, args.rds_algo)
               if with_rds else None)
    first_offsets: list[str] = []

    block_count = 0
    if args.resume:
        from sdr_fm import checkpoint
        # this path feeds RAW u8 end to end; refuse float-produced state
        # (the u8 front-end would silently quantize its RF tail)
        receiver.state, meta = checkpoint.load(args.resume,
                                               expect_input_dtype="uint8")
        block_count = meta.get("block_count", 0)
        if with_rds and "rds" in meta.get("extra", {}):
            _warn_algo_mismatch(meta["extra"]["rds"], args.rds_algo)
            rds_dec = rds_decode.StreamingRdsDecoder.load_state_dict(
                {k[len("rds/"):]: v
                 for k, v in meta["host_arrays"].items()
                 if k.startswith("rds/")},
                meta["extra"]["rds"])
        print(f"resumed from {args.resume} at block {block_count}",
              file=sys.stderr)
    n_matches_at_start = rds_dec.n_matches if rds_dec is not None else 0

    in_stream = sio.stdin_binary() if args.input == "-" else open(
        args.input, "rb")
    out_stream = None
    wav_writer = None
    if args.wav:
        # per-block incremental writes (StreamingWavWriter): host memory
        # stays O(block) however long the capture — same pattern as the
        # wideband path; byte-identical to accumulate-then-write_wav
        wav_writer = sio.StreamingWavWriter(
            args.output, mc.audio_fs, channels=2 if args.stereo else 1)
    else:
        out_stream = sio.stdout_binary() if args.output == "-" else open(
            args.output, "wb")

    # native threaded feed when a real fd is available: the producer thread
    # reads ahead of device compute (the reference's producer/consumer
    # queue, now host-side only).  Blocks stay RAW u8 end to end — the
    # receiver normalizes on-device (bit-identical; quarter the
    # host->device bytes, and the u8 front-end normalizes straight into
    # exact bfloat16)
    try:
        from sdr_fm import native
        source = native.BlockReader(in_stream.fileno(), bs, raw=True)
    except Exception:
        source = sio.iter_iq_blocks_raw(in_stream, bs)

    import jax.numpy as jnp

    def pack(out):
        """ONE device array per block: audio + RDS ride one transfer
        instead of one fetch per output."""
        parts = ([out.left, out.right] if args.stereo else [out.mono])
        if with_rds:
            parts.append(out.rds_symbols)
        return jnp.concatenate(parts)

    def emit(flat: np.ndarray) -> None:
        """Write/decode one block's packed host outputs."""
        if args.stereo:
            n_a = (len(flat) - sym_len) // 2 if with_rds else len(flat) // 2
            audio = np.stack([flat[:n_a], flat[n_a:2 * n_a]], axis=-1)
            rest = flat[2 * n_a:]
        else:
            n_a = len(flat) - sym_len
            audio, rest = flat[:n_a], flat[n_a:]
        if args.wav:
            wav_writer.write(audio)
        else:
            sio.write_pcm(out_stream, audio)
        if with_rds:
            for _, off in rds_dec.feed(rest):
                if len(first_offsets) < 12:
                    first_offsets.append(off)

    n_blocks = 0
    t0 = time.time()
    # In-flight pipeline: dispatch is async, so blocks are submitted
    # ahead while a small fetcher pool overlaps the device->host copies
    # of completed blocks (serialized fetches would bound throughput at
    # one round trip per block).  Results are consumed strictly in order, so
    # the output stream is identical to the sequential loop.  This is
    # the framework's answer to the reference's producer/consumer
    # threads (src/project.cpp:476-493) on the OUTPUT side; the native
    # BlockReader already buffers ahead on the input side.
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor
    depth = max(1, args.inflight)
    sym_len = 0
    pool = ThreadPoolExecutor(max_workers=max(2, depth // 2))
    pending: deque = deque()
    try:
        for blk in source:
            out = receiver.process(blk)
            if with_rds and not sym_len:
                sym_len = int(out.rds_symbols.shape[-1])
            pending.append(pool.submit(np.asarray, pack(out)))
            n_blocks += 1
            while len(pending) >= depth:
                emit(pending.popleft().result())
        while pending:
            emit(pending.popleft().result())
    finally:
        # drain blocks that were already computed/fetched before closing
        # the writers: an interrupt then loses at most the not-yet-
        # dispatched tail, like the old synchronous loop (guarded so a
        # wedged device cannot keep the writers open forever)
        try:
            while pending:
                emit(pending.popleft().result(timeout=30))
        except Exception:
            pass
        pool.shutdown(wait=False)
        if in_stream is not sys.stdin.buffer:
            in_stream.close()
        # close (header-patch) the wav INSIDE the finally: an exception or
        # Ctrl-C mid-capture must still rewrite the RIFF/data sizes, else
        # strict parsers reject the file
        if wav_writer is not None:
            wav_writer.close()
        elif out_stream is not None and out_stream is not sys.stdout.buffer:
            out_stream.close()

    dt = time.time() - t0
    if rds_dec is not None and not args.save_state:
        # decode whatever the CDR still buffers (tracking window tail /
        # robust estimation buffer on short captures); skipped when
        # checkpointing so the carry persists for the resumed run
        for _, off in rds_dec.flush():
            if len(first_offsets) < 12:
                first_offsets.append(off)
    if args.save_state:
        from sdr_fm import checkpoint
        extra, host_arrays = {}, {}
        if rds_dec is not None:
            arrays, rmeta = rds_dec.state_dict()
            extra["rds"] = rmeta
            host_arrays = {f"rds/{k}": v for k, v in arrays.items()}
        written = checkpoint.save(args.save_state, receiver.state, args.mode,
                                  block_count=block_count + n_blocks,
                                  extra=extra, host_arrays=host_arrays,
                                  input_dtype="uint8")
        print(f"state saved to {written} "
              f"(block {block_count + n_blocks})", file=sys.stderr)
    if with_rds and n_blocks:
        # after a resume n_matches is cumulative across the checkpoint but
        # first_offsets only covers this run — label it so the summary is
        # not misleading
        label = "first this run" if args.resume else "first"
        n_new = rds_dec.n_matches - n_matches_at_start
        corr = (f", {rds_dec.n_corrected} error-corrected"
                if rds_dec.n_corrected else "")
        print(f"RDS: {rds_dec.n_matches} frames{corr} ({label}: "
              f"{', '.join(first_offsets)}"
              f"{'...' if n_new > len(first_offsets) else ''})",
              file=sys.stderr)
        st = rds_dec.station_info()
        if st.n_groups:
            pi = f"{st.pi:04X}" if st.pi is not None else "----"
            print(f"RDS station: PI={pi} PTY={st.pty} TP={st.tp} "
                  f"PS={st.ps_name!r} RT={st.radiotext!r} "
                  f"({st.n_groups} groups {st.group_counts})",
                  file=sys.stderr)

    if args.stats and n_blocks:
        pairs = n_blocks * bs / 2
        print(f"{n_blocks} blocks, {pairs / 1e6:.2f} M IQ pairs in "
              f"{dt:.2f}s = {pairs / dt / 1e6:.1f} MS/s "
              f"({pairs / mc.rf_fs / dt:.1f}x real-time) on "
              f"{_device_label()}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
