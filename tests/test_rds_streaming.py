"""Streaming host-side RDS decode: per-block feed, O(block) memory,
checkpoint/resume reproducing the uninterrupted frame stream exactly.

This is the production-path counterpart of the reference's per-block RDS
loop (model/fmRDS.py:256-278): CDR carry + bit backlog + pending frames
travel across blocks (and across a save/resume boundary) instead of
accumulating the whole symbol stream to EOF.
"""

import numpy as np
import pytest

from sdr_fm import config as cfg
from sdr_fm.models import rds_decode, rds_groups
from sdr_fm.utils import synth

STATION = synth.StationConfig(pi=0x54B1, pty=9, ps="JAX8 FM ",
                              radiotext="HELLO JAX!", tp=True)


@pytest.fixture(scope="module")
def symbol_blocks():
    """Per-block RRC soft symbols from the JAX receiver on a synthesized
    station: (n_blocks, sym_len) float."""
    from sdr_fm.models.receiver import Receiver

    res = synth.synthesize_fm(duration_s=1.2, mode=0, seed=3,
                              with_rds=True, noise_std=0.02,
                              rds_station=STATION)
    rx = Receiver(0, stereo=True, with_rds=True)
    outs = rx.run(res.iq_u8)
    return np.asarray(outs.rds_symbols)


def _feed_all(dec, blocks):
    matches = []
    for blk in blocks:
        matches.extend(dec.feed(blk))
    return matches


class TestStreamingEquivalence:
    def test_reference_algo_matches_decode_reference(self, symbol_blocks):
        """Streaming feed with the reference CDR emits the IDENTICAL frame
        stream as decode_reference over the stacked blocks (which is itself
        pinned to the executed upstream model in
        test_reference_crosscheck)."""
        sps = cfg.get_mode_config(0).rds.sps
        batch = rds_decode.decode_reference(symbol_blocks, sps)
        dec = rds_decode.StreamingRdsDecoder(sps, algo="reference")
        matches = _feed_all(dec, symbol_blocks)
        assert matches == batch.frames.matches
        assert dec.n_matches == len(batch.frames.matches)
        # group/programme layer agrees with the batch decode too
        st_batch = rds_groups.decode_station_from(batch)
        st_stream = dec.station_info()
        assert st_stream.pi == st_batch.pi
        assert st_stream.ps_name == st_batch.ps_name
        assert st_stream.radiotext == st_batch.radiotext
        assert st_stream.n_groups == st_batch.n_groups

    def test_robust_algo_matches_decode_robust(self, symbol_blocks):
        """Streaming feed with the restart-free CDR reproduces
        decode_robust on the concatenated stream bit-for-bit, given the
        same (first-block) phase/parity estimate."""
        sps = cfg.get_mode_config(0).rds.sps
        dec = rds_decode.StreamingRdsDecoder(sps, algo="robust")
        matches = _feed_all(dec, symbol_blocks)
        flat = symbol_blocks.reshape(-1)
        manch, _, _ = rds_decode.grds.cdr_robust(flat, sps,
                                                 phase=dec.phase,
                                                 parity=dec.parity)
        bits = rds_decode.grds.diff_decode(manch)
        frames = rds_decode.grds.frame_sync(bits)
        assert matches == frames.matches
        st = dec.station_info()
        assert st.pi == STATION.pi
        assert st.ps_name == "JAX8 FM "
        assert st.radiotext == "HELLO JAX!"

    @pytest.mark.parametrize("algo", ["robust", "reference"])
    def test_block_memory_bound(self, symbol_blocks, algo):
        """Host carry is O(1): the bit backlog never exceeds one frame's
        worth past the sync tail, and at most 3 matches stay pending."""
        sps = cfg.get_mode_config(0).rds.sps
        dec = rds_decode.StreamingRdsDecoder(sps, algo=algo)
        for blk in symbol_blocks:
            dec.feed(blk)
            assert len(dec.backlog) <= 64
            assert len(dec.pending) <= 3


class TestResume:
    @pytest.mark.parametrize("algo", ["robust", "reference"])
    def test_state_dict_resume_is_exact(self, symbol_blocks, algo, tmp_path):
        """Splitting the stream at every-which block and round-tripping the
        carry through an on-disk checkpoint reproduces the uninterrupted
        frame stream and programme info EXACTLY."""
        import jax

        from sdr_fm import checkpoint
        from sdr_fm.models import receiver as rx

        sps = cfg.get_mode_config(0).rds.sps
        ref_dec = rds_decode.StreamingRdsDecoder(sps, algo=algo)
        ref_matches = _feed_all(ref_dec, symbol_blocks)

        k = len(symbol_blocks) // 2
        d1 = rds_decode.StreamingRdsDecoder(sps, algo=algo)
        m1 = _feed_all(d1, symbol_blocks[:k])
        arrays, meta = d1.state_dict()
        # persist through the real checkpoint file format
        path = checkpoint.save(
            str(tmp_path / "ck"), rx.init_state(cfg.get_mode_config(0)),
            mode=0, block_count=k, extra={"rds": meta},
            host_arrays={f"rds/{n}": v for n, v in arrays.items()})
        _, loaded = checkpoint.load(path)
        d2 = rds_decode.StreamingRdsDecoder.load_state_dict(
            {n[len("rds/"):]: v for n, v in loaded["host_arrays"].items()},
            loaded["extra"]["rds"])
        m2 = _feed_all(d2, symbol_blocks[k:])

        assert m1 + m2 == ref_matches
        st_ref, st_res = ref_dec.station_info(), d2.station_info()
        assert st_res.pi == st_ref.pi
        assert st_res.ps_name == st_ref.ps_name
        assert st_res.radiotext == st_ref.radiotext
        assert st_res.n_groups == st_ref.n_groups
        assert st_res.group_counts == st_ref.group_counts


class TestCliResume:
    def test_cli_rds_split_matches_single_run(self, tmp_path, capfd):
        """CLI --rds with --save-state / --resume: the resumed second half
        continues the RDS frame stream; total frames and group info equal
        the single uninterrupted run."""
        import re

        from sdr_fm import cli

        res = synth.synthesize_fm(duration_s=1.0, mode=0, seed=3,
                                  with_rds=True, rds_station=STATION)
        mc = cfg.get_mode_config(0)
        bs = mc.default_block_size(True)
        n_blocks = len(res.iq_u8) // bs
        k = n_blocks // 2
        whole = tmp_path / "whole.raw"
        whole.write_bytes(res.iq_u8[: n_blocks * bs].tobytes())
        p1 = tmp_path / "p1.raw"
        p2 = tmp_path / "p2.raw"
        p1.write_bytes(res.iq_u8[: k * bs].tobytes())
        p2.write_bytes(res.iq_u8[k * bs: n_blocks * bs].tobytes())

        def run(args):
            rc = cli.main(args)
            assert rc == 0
            return capfd.readouterr().err

        err_whole = run(["--mode", "0", "--rds", str(whole),
                         "-o", str(tmp_path / "a.pcm")])
        st = str(tmp_path / "state")
        run(["--mode", "0", "--rds", str(p1), "--save-state", st,
             "-o", str(tmp_path / "b1.pcm")])
        err_resumed = run(["--mode", "0", "--rds", str(p2),
                           "--resume", st + ".npz",
                           "-o", str(tmp_path / "b2.pcm")])

        def stats(err):
            frames = int(re.search(r"RDS: (\d+) frames", err).group(1))
            m = re.search(r"PI=([0-9A-F]{4}).*PS='([^']*)'", err)
            return frames, m.group(1), m.group(2)

        fw, pi_w, ps_w = stats(err_whole)
        fr, pi_r, ps_r = stats(err_resumed)
        assert fr == fw and pi_r == pi_w == f"{STATION.pi:04X}"
        assert ps_r == ps_w == "JAX8 FM "
        # audio continues bit-exactly too (device-state resume contract)
        a = (tmp_path / "a.pcm").read_bytes()
        b = ((tmp_path / "b1.pcm").read_bytes()
             + (tmp_path / "b2.pcm").read_bytes())
        assert a == b
