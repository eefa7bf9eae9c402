"""Distribution layer (counterpart of ``srcdsp_tpu/dist``): mesh, halos,
re-shards, in one process or across processes.

Streams shard two ways:

- **channel parallelism**: independent channels on different shards; no
  collective (`map_shards`);
- **time-block parallelism**: one long stream split into contiguous blocks;
  FIR and overlap-save ops need the last taps-1 samples of the left
  neighbour, one halo copy per chain step (`dist.halo`), or the K19 / K20
  kernels (``kernels/halo_dma``, ``kernels/halo_fused``) that read it in
  place;
- **all-to-all re-shard**: the channelizer turns a time-sharded wideband
  stream into channel shards by slice copies at the bank boundary.

A shard is a device in a [time, channel] mesh; a device may repeat, so P
shards share one card (or the CPU) as they share the reference's virtual CPU
devices in its tests. Across processes (`init_multihost`, then `make_mesh`
over every rank's devices) each rank holds some shards, and the halo, the
re-shard and the carried tails become messages (``dist.comm``): gloo on the
CPU and for ranks that share a card, NCCL for one card a rank.
"""

from srcdsp_tpu_torch.dist.mesh import (  # noqa: F401
    channel_sharding, init_multihost, make_mesh, shard, time_sharding, unshard)
from srcdsp_tpu_torch.dist.halo import halo_from_left, fir_time_sharded, shift_from_left  # noqa: F401
from srcdsp_tpu_torch.dist.channelize import channelize_time_sharded  # noqa: F401
