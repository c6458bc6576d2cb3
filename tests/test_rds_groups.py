"""RDS group assembly + programme-information decode.

Covers the protocol layer above the reference's frame sync
(model/fmSupportLib.py:30-100 stops at offset identification): group
assembly from matched blocks, PI/PTY/TP voting, PS name and RadioText
reconstruction — at the bit level and through the full synthesized-station
-> JAX receiver -> decode chain.
"""

import numpy as np

from sdr_fm.golden import rds as grds
from sdr_fm.models import rds_decode, rds_groups
from sdr_fm.utils import synth

STATION = synth.StationConfig(pi=0x54B1, pty=9, ps="JAX8 FM ",
                              radiotext="HELLO JAX!", tp=True)


class TestBitLevel:
    def test_station_roundtrip_exact(self):
        """encode_station -> frame_sync -> groups -> station info, exact."""
        info, framed = synth.rds_encode_station(STATION, n_groups=12)
        frames = grds.frame_sync(framed)
        assert len(frames.matches) == 48
        groups = rds_groups.assemble_groups(frames, framed)
        assert len(groups) == 12
        st = rds_groups.decode_station(groups)
        assert st.pi == STATION.pi
        assert st.pty == STATION.pty
        assert st.tp is True
        assert st.ps_name == "JAX8 FM "
        assert st.radiotext == "HELLO JAX!"
        assert st.ps_seen.all()
        # 12-char padded text = 3 RadioText segments
        assert st.rt_seen[:3].all() and not st.rt_seen[3:].any()
        assert st.group_counts == {"0A": 8, "2A": 4}

    def test_mid_stream_acquisition(self):
        """Joining mid-group (like a real receiver) still decodes."""
        _, framed = synth.rds_encode_station(STATION, n_groups=12)
        st = rds_groups.decode_station(rds_groups.assemble_groups(
            grds.frame_sync(framed[137:]), framed[137:]))
        assert st.pi == STATION.pi and st.ps_name == "JAX8 FM "

    def test_version_b_group_with_c_prime_offset(self):
        """Version B groups (offset C') carry PI in block C and 2 RadioText
        chars per group in block D."""
        b_word = (2 << 12) | (1 << 11) | (9 << 5) | 0  # 2B, pty 9, addr 0
        words = [0x54B1, b_word, 0x54B1, (ord("H") << 8) | ord("i")]
        bits = np.concatenate([
            synth.rds_encode_block(synth._int_to_bits(w, 16), off)
            for w, off in zip(words, ("A", "B", "C_apos", "D"))])
        groups = rds_groups.assemble_groups(grds.frame_sync(bits), bits)
        assert len(groups) == 1 and groups[0].version == "B"
        st = rds_groups.decode_station(groups)
        assert st.pi == 0x54B1
        assert st.radiotext.startswith("Hi")
        assert st.group_counts == {"2B": 1}

    def test_majority_voting_survives_corrupt_block(self):
        """A flipped info word in one group cannot flip PI/PTY."""
        info, framed = synth.rds_encode_station(STATION, n_groups=8)
        groups = rds_groups.assemble_groups(grds.frame_sync(framed), framed)
        groups[0].words[0] = 1 - groups[0].words[0]   # corrupt one block A
        st = rds_groups.decode_station(groups)
        assert st.pi == STATION.pi and st.pty == STATION.pty


class TestEndToEnd:
    def test_full_chain_recovers_programme_info(self):
        """Synthesized station -> JAX receiver -> PS name + RadioText."""
        import jax
        from sdr_fm import get_mode_config
        from sdr_fm.models.receiver import Receiver

        mc = get_mode_config(0)
        res = synth.synthesize_fm(duration_s=1.2, mode=0, seed=3,
                                  with_rds=True, noise_std=0.02,
                                  rds_station=STATION)
        rx = Receiver(0, stereo=True, with_rds=True)
        outs = rx.run(res.iq_u8)
        dec = rds_decode.decode_robust(np.asarray(outs.rds_symbols),
                                       mc.rds.sps)
        st = rds_groups.decode_station_from(dec)
        assert st.n_groups >= 8
        assert st.pi == STATION.pi
        assert st.pty == STATION.pty
        assert st.ps_name == "JAX8 FM "
        assert st.radiotext == "HELLO JAX!"
