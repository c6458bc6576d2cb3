"""Multi-device sharding on the 8-device virtual CPU mesh (conftest).

Validates the two scale-out axes (SURVEY.md §2.3, §7 step 8):
channel-parallel equals per-channel serial runs, and time-sharded halo
exchange equals contiguous processing (exactly for the linear arms, to
PLL-tracking tolerance for the stereo arm after overlap discard).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from sdr_fm import config as cfg
from sdr_fm.models import receiver as trx
from sdr_fm.parallel import channel_sharded_run, time_sharded_receive
from sdr_fm.utils import synth


@pytest.fixture(scope="module")
def mesh8():
    devs = jax.devices()
    assert len(devs) >= 8, "conftest must provide 8 virtual devices"
    return Mesh(np.array(devs[:8]), ("d",))


class TestMultihostHelpers:
    def test_make_mesh_layout(self):
        from sdr_fm.parallel import multihost
        mesh = multihost.make_mesh(time_per_host=4)
        assert mesh.shape == {"ch": 2, "time": 4}

    def test_mesh_runs_2d_receive(self):
        """The multihost-policy mesh drives the composed 2D program."""
        from sdr_fm.parallel import multihost
        mesh = multihost.make_mesh(time_per_host=4)
        mc = cfg.get_mode_config(0)
        mult = mc.if_block_multiple(False)
        overlap = 40 * mult
        seg = 3 * overlap * 2 * mc.rf_decim
        rng = np.random.default_rng(0)
        iq = rng.uniform(-1, 1, (2, 4 * seg)).astype(np.float32)
        outs = time_sharded_receive(iq, mesh, 0, stereo=True,
                                    with_rds=False, overlap_if=overlap,
                                    block_if=overlap,
                                    axis="time", batch_axis="ch")
        assert np.isfinite(np.asarray(outs.left)).all()


class TestNoiseRobustness:
    def test_pure_noise_never_nans(self):
        """Unlocked PLLs and zero-signal stretches must stay finite — the
        failure-containment property behind the reference's NaN clamp."""
        mc = cfg.get_mode_config(0)
        bs = mc.default_block_size(with_rds=True)
        rng = np.random.default_rng(3)
        raw = rng.integers(0, 256, 3 * bs, dtype=np.uint8)
        iq = (raw.astype(np.float32) - 128.0) / 128.0
        rx = trx.Receiver(0, stereo=True, with_rds=True)
        for b in range(3):
            out = rx.process(iq[b * bs:(b + 1) * bs])
            for f in out._fields:
                assert np.isfinite(np.asarray(getattr(out, f))).all(), f

    def test_zero_input_stays_finite(self):
        mc = cfg.get_mode_config(0)
        bs = mc.default_block_size(with_rds=True)
        rx = trx.Receiver(0, stereo=True, with_rds=True)
        out = rx.process(np.zeros(bs, np.float32))
        for f in out._fields:
            assert np.isfinite(np.asarray(getattr(out, f))).all(), f


class TestChannelParallel:
    def test_matches_serial_per_channel(self, mesh8):
        mc = cfg.get_mode_config(0)
        bs = mc.default_block_size()
        chans = []
        for seed in range(8):
            r = synth.synthesize_fm(duration_s=0.05, mode=0, seed=seed,
                                    with_rds=False,
                                    tone_l=400.0 + 100 * seed,
                                    tone_r=2600.0 - 200 * seed)
            chans.append(synth.u8_to_float(r.iq_u8)[:2 * bs])
        iqc = np.stack(chans)

        outs, _ = channel_sharded_run(iqc, mesh8, 0, stereo=True, axis="d")
        left = np.asarray(outs.left)  # (n_blocks, C, out)
        assert left.shape[1] == 8

        for c in [0, 3, 7]:
            rxs = trx.Receiver(0, stereo=True)
            souts = rxs.run(iqc[c])
            np.testing.assert_allclose(left[:, c], np.asarray(souts.left),
                                       atol=1e-4)

    def test_256_channel_batch_shape(self, mesh8):
        """The pod-scale config (BASELINE.json): a 256-channel batch
        sharded over the mesh compiles and runs with per-device shards of
        32 channels; spot-check one channel against a serial run."""
        mc = cfg.get_mode_config(0)
        bs = 4000 * 2 * mc.rf_decim  # small block for test speed
        r = synth.synthesize_fm(duration_s=0.05, mode=0, seed=0,
                                with_rds=False)
        one = synth.u8_to_float(r.iq_u8)[:bs]
        iqc = np.tile(one, (256, 1))
        outs, state = channel_sharded_run(iqc, mesh8, 0, stereo=True,
                                          axis="d", block_size=bs)
        left = np.asarray(outs.left)
        assert left.shape[1] == 256
        rxs = trx.Receiver(0, stereo=True)
        ref = rxs.process(one)
        np.testing.assert_allclose(left[0, 17], np.asarray(ref.left),
                                   atol=1e-5)

    def test_output_is_sharded(self, mesh8):
        mc = cfg.get_mode_config(0)
        bs = mc.default_block_size()
        r = synth.synthesize_fm(duration_s=0.05, mode=0, seed=0,
                                with_rds=False)
        iqc = np.tile(synth.u8_to_float(r.iq_u8)[:bs], (8, 1))
        outs, state = channel_sharded_run(iqc, mesh8, 0, stereo=False,
                                          axis="d")
        # mono output stays distributed over the channel axis — no gather
        shard_devs = {s.device for s in outs.mono.addressable_shards}
        assert len(shard_devs) == 8


class TestPlacement:
    """Host input goes straight into its sharding: one shard per device,
    never a full copy staged on the first device."""

    def test_put_sharded_reads_only_shards(self, mesh8):
        from jax.sharding import NamedSharding

        from sdr_fm.parallel.channel import put_sharded
        host = np.arange(8 * 3 * 5, dtype=np.float32).reshape(8, 3, 5)
        reads = []

        class Recording(np.ndarray):
            def __getitem__(self, idx):
                reads.append(idx)
                return np.asarray(self).__getitem__(idx)

        arr = put_sharded(host.view(Recording),
                          NamedSharding(mesh8, P("d")))
        assert len(reads) == 8
        assert all(np.asarray(host[i]).size * 8 == host.size
                   for i in reads)
        shards = arr.addressable_shards
        assert len({s.device for s in shards}) == 8
        for s in shards:
            assert s.data.shape == (1, 3, 5)
            np.testing.assert_array_equal(np.asarray(s.data),
                                          host[s.index])

    def _record_puts(self, monkeypatch, module):
        puts = []
        real = module.put_sharded

        def wrapped(host, sharding):
            puts.append((type(host), host.shape, sharding))
            return real(host, sharding)

        monkeypatch.setattr(module, "put_sharded", wrapped)
        return puts

    def test_channel_sharded_run_places_one_shard_per_device(
            self, mesh8, monkeypatch):
        from sdr_fm.parallel import channel
        puts = self._record_puts(monkeypatch, channel)
        mc = cfg.get_mode_config(0)
        bs = mc.default_block_size()
        iq = np.random.default_rng(1).integers(0, 256, (16, 2 * bs),
                                               dtype=np.uint8)
        outs, state = channel_sharded_run(iq, mesh8, 0, stereo=True,
                                          axis="d")
        (kind, shape, sharding), = puts
        assert kind is np.ndarray and shape == (2, 16, bs)
        assert sharding.spec == P(None, "d", None)
        for leaf in (outs.left, state.rf_i, state.pilot_pll.phase_est):
            shards = leaf.addressable_shards
            assert len({s.device for s in shards}) == 8
            assert all(s.data.shape[list(leaf.shape).index(16)] == 2
                       for s in shards)

    def test_time_sharded_receive_places_one_shard_per_device(
            self, mesh8, monkeypatch):
        from sdr_fm.parallel import time_shard
        puts = self._record_puts(monkeypatch, time_shard)
        mc = cfg.get_mode_config(0)
        mult = mc.if_block_multiple(False)
        seg = 3 * 40 * mult * 2 * mc.rf_decim
        iq = np.random.default_rng(2).uniform(-1, 1, 8 * seg)
        outs = time_sharded_receive(iq, mesh8, 0, stereo=False,
                                    overlap_if=40 * mult,
                                    block_if=40 * mult, axis="d")
        (kind, shape, sharding), = puts
        assert kind is np.ndarray and shape == (8 * seg,)
        assert sharding.spec == P("d")
        assert len({s.device for s in outs.mono.addressable_shards}) == 8


class TestTimeSharded:
    @pytest.fixture(scope="class")
    def recording(self):
        res = synth.synthesize_fm(duration_s=0.45, mode=0, with_stereo=True,
                                  with_rds=True, seed=21)
        return synth.u8_to_float(res.iq_u8), res

    def _trim(self, iq, mc, s, with_rds):
        from sdr_fm.parallel.time_shard import default_block_if
        gran = default_block_if(mc, with_rds) * 2 * mc.rf_decim
        seg = (iq.shape[-1] // s) // gran * gran
        return iq[: seg * s]

    def test_linear_arms_match_contiguous_exactly(self, mesh8, recording):
        iq, _ = recording
        mc = cfg.get_mode_config(0)
        iq = self._trim(iq, mc, 8, True)
        outs = time_sharded_receive(iq, mesh8, 0, stereo=True, with_rds=True,
                                    axis="d")

        rxs = trx.Receiver(0, stereo=True, with_rds=True)
        ref = rxs.run(iq, block_size=iq.shape[-1])
        fm_ref = np.asarray(ref.fm_demod).reshape(-1)
        mono_ref = np.asarray(ref.mono).reshape(-1)

        fm = np.asarray(outs.fm_demod)
        np.testing.assert_allclose(fm, fm_ref, atol=1e-5)
        # mono passes the allpass delay + audio FIR — still fully linear
        np.testing.assert_allclose(np.asarray(outs.mono), mono_ref, atol=1e-5)

    def test_stereo_converges_after_relock(self, mesh8, recording):
        iq, _ = recording
        mc = cfg.get_mode_config(0)
        iq = self._trim(iq, mc, 8, False)
        outs = time_sharded_receive(iq, mesh8, 0, stereo=True,
                                    with_rds=False, axis="d")

        rxs = trx.Receiver(0, stereo=True)
        ref = rxs.run(iq, block_size=iq.shape[-1])
        left_ref = np.asarray(ref.left).reshape(-1)
        left = np.asarray(outs.left)
        assert left.shape == left_ref.shape
        # shard 0 resets to the exact fresh state after its zero warm-up,
        # so its output matches contiguous from sample 0 (roundoff through
        # the chaotic PLL transient aside)
        first_shard = left_ref.shape[0] // 8
        np.testing.assert_allclose(left[:first_shard],
                                   left_ref[:first_shard], atol=1e-2)
        # later shards: the PLL fully re-locks within ONE overlap block —
        # measured kept-region error sits at the float32 roundoff floor
        # (~1.5e-7 rel RMS) for every overlap >= 1 block and noise up to
        # std 0.1 (scripts/overlap_convergence.py ->
        # docs/overlap_convergence.json); gate at 1e-4: ~700x above the
        # floor, 10x tighter than the 1e-3 output tolerance target
        skip = 8000
        err = np.sqrt(np.mean((left[skip:] - left_ref[skip:]) ** 2))
        ref_rms = np.sqrt(np.mean(left_ref[skip:] ** 2))
        assert err < 1e-4 * ref_rms, (err, ref_rms)

    def test_2d_mesh_channel_by_time(self, recording):
        """dp x sp composition: 2 channels x 4 time shards on a 2D mesh."""
        iq, _ = recording
        mc = cfg.get_mode_config(0)
        iq1 = self._trim(iq, mc, 4, False)
        iqc = np.stack([iq1, iq1 * 0.75])

        mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4),
                    ("ch", "time"))
        outs = time_sharded_receive(iqc, mesh, 0, stereo=False,
                                    with_rds=False, axis="time",
                                    batch_axis="ch")
        mono = np.asarray(outs.mono)
        assert mono.shape[0] == 2
        rxs = trx.Receiver(0, stereo=False)
        ref = np.asarray(rxs.run(iq1, block_size=iq1.shape[-1]).mono
                         ).reshape(-1)
        np.testing.assert_allclose(mono[0], ref, atol=1e-5)

    def test_mode2_rational_time_sharding(self, mesh8):
        """Time sharding with the rational (147/800) audio resampler:
        block multiples are much coarser but linear-arm parity holds."""
        mc = cfg.get_mode_config(2)
        res = synth.synthesize_fm(duration_s=0.6, mode=2, with_stereo=False,
                                  with_rds=False, seed=17)
        iq = synth.u8_to_float(res.iq_u8)
        iq = self._trim(iq, mc, 8, False)
        outs = time_sharded_receive(iq, mesh8, 2, stereo=False,
                                    with_rds=False, axis="d")
        rxs = trx.Receiver(2, stereo=False)
        ref = rxs.run(iq, block_size=iq.shape[-1])
        np.testing.assert_allclose(np.asarray(outs.mono),
                                   np.asarray(ref.mono).reshape(-1),
                                   atol=1e-5)

    def test_rds_symbols_survive_sharding(self, mesh8, recording):
        """Time-sharded soft symbols still decode every RDS frame."""
        from sdr_fm.models import rds_decode
        iq, res = recording
        mc = cfg.get_mode_config(0)
        iq = self._trim(iq, mc, 8, True)
        outs = time_sharded_receive(iq, mesh8, 0, stereo=False, with_rds=True,
                                    axis="d")
        dec = rds_decode.decode_robust(np.asarray(outs.rds_symbols),
                                       mc.rds.sps)
        sent = {tuple(w) for g in res.rds_info_bits for w in g}
        hits = sum(tuple(w) in sent for w in dec.info_words)
        assert len(dec.frames.matches) >= 10
        assert hits >= len(dec.frames.matches) - 2
