"""Chunk-streaming long captures: device/host memory O(chunk), outputs
bit-identical to the stacked paths (BASELINE.json's
pod-scale config names a 1-hour capture that the stacked outputs of
``Receiver.run`` / ``time_sharded_receive`` would not hold).
"""

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from sdr_fm import config as cfg
from sdr_fm.models.receiver import Receiver
from sdr_fm.parallel import time_shard
from sdr_fm.utils import synth


@pytest.fixture(scope="module")
def station_iq():
    res = synth.synthesize_fm(duration_s=0.9, mode=0, seed=7,
                              with_stereo=True, with_rds=True)
    return res.iq_u8


class TestReceiverIterRun:
    @pytest.mark.parametrize("chunk_blocks", [1, 3, 64])
    def test_concat_equals_run(self, station_iq, chunk_blocks):
        """iter_run chunks concatenated == one run(), bit-identical, for
        chunk sizes from degenerate (1 block) past the recording length."""
        rx_a = Receiver(0, stereo=True, with_rds=True)
        rx_b = Receiver(0, stereo=True, with_rds=True)
        whole = rx_a.run(station_iq)
        chunks = list(rx_b.iter_run(station_iq, chunk_blocks=chunk_blocks))
        for field in ("fm_demod", "mono", "left", "right", "rds_symbols"):
            ref = np.asarray(getattr(whole, field))
            got = np.concatenate([getattr(c, field) for c in chunks], axis=0)
            np.testing.assert_array_equal(got, ref, err_msg=field)
        # the carried state matches too — resuming after either is identical
        for a, b in zip(jax.tree.leaves(rx_a.state),
                        jax.tree.leaves(rx_b.state)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_batched_channels(self, station_iq):
        """Leading channel-batch dims stream through chunks unchanged."""
        iq2 = np.stack([station_iq, station_iq[::-1].copy()])
        rx_a = Receiver(0, stereo=True, batch_shape=(2,))
        rx_b = Receiver(0, stereo=True, batch_shape=(2,))
        whole = rx_a.run(iq2)
        got = np.concatenate(
            [c.mono for c in rx_b.iter_run(iq2, chunk_blocks=4)], axis=0)
        np.testing.assert_array_equal(got, np.asarray(whole.mono))


class TestTimeShardedChunked:
    @pytest.fixture(scope="class")
    def mesh(self):
        return Mesh(np.array(jax.devices()[:4]), ("time",))

    def _trim(self, iq, s, with_rds):
        mc = cfg.get_mode_config(0)
        block_raw = time_shard.default_block_if(mc, with_rds) * 2 * mc.rf_decim
        seg = (iq.shape[-1] // s) // block_raw * block_raw
        return (np.asarray(iq, np.float32)[..., : s * seg] - 128.0) / 128.0

    @pytest.mark.parametrize("chunk_blocks", [2, 7, 1000])
    def test_assembled_equals_single_shot(self, station_iq, mesh,
                                          chunk_blocks):
        """Chunked shards assemble bit-identically to the single-shot
        sharded run — same halo values, same shard-0 reset, same kernels."""
        iq = self._trim(station_iq, 4, True)
        ref = time_shard.time_sharded_receive(iq, mesh, 0, stereo=True,
                                              with_rds=True)
        chunks = list(time_shard.time_sharded_receive_chunked(
            iq, mesh, 0, stereo=True, with_rds=True,
            chunk_blocks=chunk_blocks))
        got = time_shard.assemble_time_chunks(chunks)
        for arm in ("fm_demod", "mono", "left", "right", "rds_symbols"):
            np.testing.assert_array_equal(
                got[arm], np.asarray(getattr(ref, arm)), err_msg=arm)

    def test_2d_mesh_channel_batch(self, station_iq):
        """ch x time 2D mesh: chunked == single-shot for a channel batch."""
        devs = np.array(jax.devices()[:8]).reshape(2, 4)
        mesh = Mesh(devs, ("ch", "time"))
        base = self._trim(station_iq, 4, False)
        iq2 = np.stack([base, base * 0.5])
        ref = time_shard.time_sharded_receive(iq2, mesh, 0, stereo=True,
                                              batch_axis="ch")
        chunks = list(time_shard.time_sharded_receive_chunked(
            iq2, mesh, 0, stereo=True, batch_axis="ch", chunk_blocks=3))
        got = time_shard.assemble_time_chunks(chunks)
        for arm in ("mono", "left"):
            np.testing.assert_array_equal(
                got[arm], np.asarray(getattr(ref, arm)), err_msg=arm)

    def test_memory_is_chunk_bounded(self, station_iq, mesh):
        """Per-chunk outputs are O(chunk), independent of recording length:
        the generator never materializes more than one chunk of output."""
        iq = self._trim(station_iq, 4, False)
        gen = time_shard.time_sharded_receive_chunked(
            iq, mesh, 0, stereo=False, chunk_blocks=2)
        mc = cfg.get_mode_config(0)
        per = (time_shard.default_block_if(mc, False)
               * mc.audio_upsamp // mc.audio_decim)
        for out in gen:
            assert out["mono"].shape[-1] <= 2 * per
