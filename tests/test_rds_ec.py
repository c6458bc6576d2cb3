"""RDS burst error correction (round 5; capability beyond the reference).

The (26,16) shortened cyclic block code corrects any single burst
spanning <= 5 bits; the reference's framesync requires exact syndrome
matches (model/fmSupportLib.py:30-100) and drops every disturbed block.
golden.rds.correct_block + frame_sync_ec recover them while frame-
synchronized, exact-match acquisition unchanged.
"""

import numpy as np
import pytest

from sdr_fm.golden import rds as grds
from sdr_fm.utils import synth


def _group_bits(rng, n_groups=8):
    """Clean framed bitstream of n_groups A,B,C,D groups + its blocks."""
    blocks = []
    for _ in range(n_groups):
        for off in ("A", "B", "C", "D"):
            info = rng.integers(0, 2, 16)
            blocks.append((off, synth.rds_encode_block(info, off)))
    bits = np.concatenate([b for _, b in blocks])
    return bits, blocks


def _burst(rng, max_len=5):
    length = int(rng.integers(1, max_len + 1))
    start = int(rng.integers(0, 26 - length + 1))
    e = np.zeros(26, np.int64)
    e[start] = 1
    e[start + length - 1] = 1
    for b in range(start + 1, start + length - 1):
        e[b] = rng.integers(0, 2)
    return e


class TestCorrectBlock:
    def test_table_injective_over_bursts(self):
        """All 367 burst-<=5 patterns have distinct syndromes (the
        shortened cyclic code's design property)."""
        assert len(grds._CORRECTION_TABLE) == 367

    def test_every_burst_corrected(self):
        rng = np.random.default_rng(0)
        for trial in range(200):
            off = ("A", "B", "C", "D", "C_apos")[trial % 5]
            w = synth.rds_encode_block(rng.integers(0, 2, 16), off)
            e = _burst(rng)
            win, ne = grds.correct_block(w ^ e, off)
            np.testing.assert_array_equal(win, w)
            assert ne == int(e.sum())

    def test_clean_block_zero_flips(self):
        w = synth.rds_encode_block(np.ones(16, np.int64), "B")
        win, ne = grds.correct_block(w, "B")
        assert ne == 0
        np.testing.assert_array_equal(win, w)

    def test_uncorrectable_returns_none(self):
        """A 6-bit spread error is outside the burst capability; verify a
        pattern whose syndrome is not in the table refuses."""
        rng = np.random.default_rng(3)
        w = synth.rds_encode_block(rng.integers(0, 2, 16), "A")
        refused = 0
        for _ in range(100):
            e = np.zeros(26, np.int64)
            e[rng.choice(26, size=6, replace=False)] = 1
            if grds.correct_block(w ^ e, "A") is None:
                refused += 1
        assert refused > 50          # most wide errors must refuse


class TestFrameSyncEc:
    def test_clean_stream_identical_to_exact(self):
        rng = np.random.default_rng(1)
        bits, _ = _group_bits(rng)
        exact = grds.frame_sync(bits)
        ec = grds.frame_sync_ec(bits)
        assert [(p, o) for p, o, _, _ in ec.matches] == exact.matches
        assert ec.consumed == exact.consumed
        assert all(ne == 0 for _, _, _, ne in ec.matches)

    def test_recovers_bursted_blocks(self):
        """Bursts injected into synced blocks: exact sync drops them, EC
        recovers them with the ORIGINAL info bits."""
        rng = np.random.default_rng(2)
        bits, blocks = _group_bits(rng, n_groups=8)
        dirty = bits.copy()
        # corrupt blocks 3, 7, 12 (after sync is established by 0-2)
        for k in (3, 7, 12):
            dirty[k * 26:(k + 1) * 26] ^= _burst(rng)
        exact = grds.frame_sync(dirty)
        ec = grds.frame_sync_ec(dirty)
        assert len(exact.matches) < len(blocks)       # reference drops
        assert len(ec.matches) == len(blocks)         # EC saves them all
        for (p, o, win, ne), (off_true, w_true) in zip(ec.matches, blocks):
            assert o == off_true
            np.testing.assert_array_equal(win, w_true)

    def test_c_apos_not_miscorrected_to_c(self):
        """A 1-bit-damaged C' block must come back as C' with ONE flip,
        not be rewritten into a bogus C block: the error syndrome toward
        C is d ^ (S_C ^ S_C'), which for several positions is also a
        correctable burst — minimum-weight candidate selection resolves
        it (found by the r5 review, verified by execution)."""
        rng = np.random.default_rng(9)
        blocks = []
        for g in range(4):
            for off in ("A", "B", "C_apos", "D"):    # version-B groups
                blocks.append((off, synth.rds_encode_block(
                    rng.integers(0, 2, 16), off)))
        bits = np.concatenate([b for _, b in blocks])
        for errbit in range(26):
            dirty = bits.copy()
            k = 6                                    # a C' block, synced
            dirty[k * 26 + errbit] ^= 1
            ec = grds.frame_sync_ec(dirty)
            assert len(ec.matches) == len(blocks), errbit
            p, o, win, ne = ec.matches[k]
            assert o == "C_apos", (errbit, o)
            assert ne == 1, (errbit, ne)
            np.testing.assert_array_equal(win, blocks[k][1])

    def test_streak_bounded(self):
        """More than MAX_CORRECTION_STREAK consecutive corrupted blocks:
        the scan must NOT keep correcting blindly."""
        rng = np.random.default_rng(4)
        bits, blocks = _group_bits(rng, n_groups=8)
        dirty = bits.copy()
        for k in (4, 5, 6, 7):                        # 4 consecutive
            dirty[k * 26:(k + 1) * 26] ^= _burst(rng)
        ec = grds.frame_sync_ec(dirty)
        n_corr = sum(1 for _, _, _, ne in ec.matches if ne)
        assert n_corr <= grds.MAX_CORRECTION_STREAK
        # sync must re-acquire on the clean blocks afterwards
        assert any(p == 8 * 26 for p, _, _, _ in ec.matches)

    def test_streaming_chunks_match_contiguous(self):
        rng = np.random.default_rng(5)
        bits, _ = _group_bits(rng, n_groups=10)
        dirty = bits.copy()
        for k in (3, 9, 14, 20):
            dirty[k * 26:(k + 1) * 26] ^= _burst(rng)
        whole = grds.frame_sync_ec(dirty)
        got = []
        st = None
        pos = 0
        consumed_abs = 0
        backlog = np.zeros(0, np.int64)
        for c0 in range(0, len(dirty), 97):            # awkward chunking
            stream = np.concatenate([backlog, dirty[c0:c0 + 97]])
            r = grds.frame_sync_ec(stream, st)
            st = r.state
            got.extend([(consumed_abs + p, o, tuple(w), ne)
                        for p, o, w, ne in r.matches])
            backlog = stream[r.consumed:]
            consumed_abs += r.consumed
        want = [(p, o, tuple(w), ne) for p, o, w, ne in whole.matches]
        assert got == want


class TestStreamingDecoderEc:
    def test_corrected_frames_counted_and_resumed(self, tmp_path):
        """The streaming decoder recovers corrupted frames, counts them,
        and the EC carry round-trips through state_dict."""
        from sdr_fm import config as cfg
        from sdr_fm.models import rds_decode
        sps = cfg.get_mode_config(0).rds.sps
        rng = np.random.default_rng(6)
        bits, blocks = _group_bits(rng, n_groups=10)
        dirty = bits.copy()
        for k in (5, 13):
            dirty[k * 26:(k + 1) * 26] ^= _burst(rng)
        # drive the decoder at the bit level through its frame scanner
        dec = rds_decode.StreamingRdsDecoder(sps, "robust")
        dec.phase, dec.parity = 0, 0          # skip symbol-clock estimation
        # feed Manchester-level bits directly via _advance's contract:
        # diff_decode is the inverse of synth.diff_encode
        manch = synth.diff_encode(dirty)
        dec._advance(manch)
        assert dec.n_corrected == 2
        assert dec.n_matches == len(blocks)
        arrays, meta = dec.state_dict()
        d2 = rds_decode.StreamingRdsDecoder.load_state_dict(arrays, meta)
        assert d2.n_corrected == 2
        assert d2.error_correction
        assert d2.sync_scan == dec.sync_scan

    def test_version_b_groups_decode_end_to_end(self):
        """The synth transmitter's version-B mix (0B/2B: version bit set,
        PI repeated in block 3 under offset C') decodes to the same
        station info — closing the ground-truth gap on the decoder's
        B-group path (it was only ever fed version A)."""
        from sdr_fm import config as cfg
        from sdr_fm.models import rds_decode
        st = synth.StationConfig(pi=0x54B1, pty=9, ps="JAX8 FM ",
                                 radiotext="HELLO JAX!", tp=True)
        _, framed = synth.rds_encode_station(st, n_groups=24,
                                             version_b=True)
        sps = cfg.get_mode_config(0).rds.sps
        dec = rds_decode.StreamingRdsDecoder(sps, "robust")
        dec.phase, dec.parity = 0, 0
        dec._advance(synth.diff_encode(framed))
        si = dec.station_info()
        assert si.pi == 0x54B1 and si.ps_name == "JAX8 FM "
        assert si.radiotext == "HELLO JAX!"
        assert si.group_counts.get("0B") and si.group_counts.get("2B")

    def test_ec_off_matches_reference_behavior(self):
        from sdr_fm import config as cfg
        from sdr_fm.models import rds_decode
        sps = cfg.get_mode_config(0).rds.sps
        rng = np.random.default_rng(7)
        bits, blocks = _group_bits(rng, n_groups=6)
        dirty = bits.copy()
        dirty[4 * 26:5 * 26] ^= _burst(rng)
        dec = rds_decode.StreamingRdsDecoder(sps, "robust",
                                             error_correction=False)
        dec.phase, dec.parity = 0, 0
        dec._advance(synth.diff_encode(dirty))
        assert dec.n_corrected == 0
        assert dec.n_matches < len(blocks)
