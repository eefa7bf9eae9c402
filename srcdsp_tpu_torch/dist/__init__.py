"""Distribution layer (counterpart of ``srcdsp_tpu/dist``): mesh, halos,
re-shards, in one process.

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
devices in its tests.
"""

from srcdsp_tpu_torch.dist.mesh import make_mesh, shard, unshard  # noqa: F401
from srcdsp_tpu_torch.dist.halo import halo_from_left, fir_time_sharded, shift_from_left  # noqa: F401
from srcdsp_tpu_torch.dist.channelize import channelize_time_sharded  # noqa: F401
