"""Scale-out layer: device-mesh sharding for the receiver.

The reference's only parallelism is a 2-thread producer/consumer queue on
one host (src/project.cpp:470-493).  The device-mesh equivalents
(SURVEY.md §2.3) are:

* **channel parallelism** — a batch of independent FM channels sharded over
  chips (the data-parallel axis); embarrassingly parallel via jit +
  NamedSharding.
* **time parallelism** — one long recording split into contiguous segments
  across chips, made bit-comparable to contiguous processing by halo
  exchange: each shard receives an overlap prefix from its left neighbor
  over ICI (``lax.ppermute`` inside ``shard_map``), warms up its filter and
  PLL state on the overlap, and discards the overlap outputs.
"""

from sdr_fm.parallel.channel import channel_sharded_run  # noqa: F401
from sdr_fm.parallel.time_shard import time_sharded_receive  # noqa: F401
