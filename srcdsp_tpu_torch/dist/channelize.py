"""Distributed channelizer: time-sharded wideband in, channel-sharded out
(counterpart of ``srcdsp_tpu/dist/channelize.py``).

Each time shard runs the polyphase bank (``chains.channelizer``) on its own
contiguous block, with a left halo of T-1 samples so frames are globally
seamless, and produces all M channels for its local frames. The reference's
``lax.all_to_all`` (split the channel axis, concatenate the frame axes in
device order) becomes slice copies: shard q receives channels
[q*M/P, (q+1)*M/P) of every shard's frames, concatenated in mesh order, on
its own device. The re-sharded output is then a pure layout change of
``channelize_full``.
"""

from __future__ import annotations

import torch

from srcdsp_tpu_torch.chains.channelizer import (
    ChannelizerState, channelize_apply, channelize_os2_apply, pad_prototype)
from srcdsp_tpu_torch.dist.halo import from_left, halo_from_left, trailing
from srcdsp_tpu_torch.dist.mesh import TIME_AXIS, Mesh, copy_to, map_shards


def _check_channels(num_channels: int, mesh: Mesh) -> None:
    p = mesh.shape[TIME_AXIS]
    if num_channels % p != 0:
        raise ValueError(f"num_channels {num_channels} not divisible by time-axis size {p}")


def all_to_all(banks, devices) -> tuple[torch.Tensor, ...]:
    """banks[p] [..., M, K_p] -> shard q: [..., M/P, sum K_p] on devices[q],
    channels q*M/P .. (q+1)*M/P - 1 of every shard, frames in mesh order."""
    w = banks[0].shape[-2] // len(banks)
    return tuple(torch.cat([b[..., q * w:(q + 1) * w, :].to(d) for b in banks], dim=-1)
                 for q, d in enumerate(devices))


def _bank_shards(apply, taps, tails, shards, num_channels: int, mesh: Mesh):
    banks = map_shards(lambda tail, x: apply(taps, ChannelizerState(tail=tail), x,
                                             num_channels)[1], mesh, tails, shards)
    return all_to_all(banks, mesh.axis_devices())


def _tail_len(taps, num_channels: int) -> int:
    return pad_prototype(taps, num_channels).shape[0] - 1


def channelize_time_sharded(taps, shards, num_channels: int, mesh: Mesh
                            ) -> tuple[torch.Tensor, ...]:
    """Shards [..., S_local] (time) -> [..., M/P, S/M] per shard (channels).

    Requires S_local % M == 0 (whole frames per shard) and M % P == 0."""
    _check_channels(num_channels, mesh)
    tails = halo_from_left(shards, _tail_len(taps, num_channels))
    return _bank_shards(channelize_apply, taps, tails, shards, num_channels, mesh)


def channelize_time_sharded_stream(taps, state_tail: torch.Tensor, shards, num_channels: int,
                                   mesh: Mesh
                                   ) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
    """Streaming form: successive time-sharded buffers channelize seamlessly.

    state_tail [..., T-1] (zeros at stream start). Returns (new tail on shard
    0's device, the channel shards); concatenated outputs across calls equal
    one single-device streaming run (as ``dist.halo.fir_time_sharded_stream``)."""
    _check_channels(num_channels, mesh)
    local = trailing(shards, _tail_len(taps, num_channels))
    ys = _bank_shards(channelize_apply, taps, from_left(local, state_tail), shards,
                      num_channels, mesh)
    return copy_to(local[-1], shards[0].device), ys


def channelize_os2_time_sharded(taps, shards, num_channels: int, mesh: Mesh
                                ) -> tuple[torch.Tensor, ...]:
    """2x-oversampled variant: [..., S_local] time shards -> [..., M/P, 2S/M]
    channel shards. The (-1)^{m*k} twiddle uses the LOCAL frame index, so each
    shard's length must be a multiple of M (not only M/2): an even local frame
    count keeps the frame parity globally consistent."""
    _check_channels(num_channels, mesh)
    for x in shards:
        if x.shape[-1] % num_channels != 0:
            raise ValueError(f"os2 per-shard length {x.shape[-1]} must be a multiple of "
                             f"num_channels {num_channels} for global frame-parity "
                             f"consistency")
    tails = halo_from_left(shards, _tail_len(taps, num_channels))
    return _bank_shards(channelize_os2_apply, taps, tails, shards, num_channels, mesh)
