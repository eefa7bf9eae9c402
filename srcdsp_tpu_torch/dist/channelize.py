"""Distributed channelizer: time-sharded wideband in, channel-sharded out
(counterpart of ``srcdsp_tpu/dist/channelize.py``).

Each time shard runs the polyphase bank (``chains.channelizer``) on its own
contiguous block, with a left halo of T-1 samples so frames are globally
seamless, and produces all M channels for its local frames. The reference's
``lax.all_to_all`` (split the channel axis, concatenate the frame axes in
device order) becomes slice copies: shard q receives channels
[q*M/P, (q+1)*M/P) of every shard's frames, concatenated in mesh order, on
its own device. Across processes the pieces for another rank's shards go in
one ``all_to_all`` (``dist.comm``: NCCL under ``nccl``, host-staged under
gloo), so (R-1)/R of the bank crosses the process boundary with R ranks. The
re-sharded output is then a pure layout change of ``channelize_full``.
"""

from __future__ import annotations

import torch

from srcdsp_tpu_torch.chains.channelizer import (
    ChannelizerState, channelize_apply, channelize_os2_apply, pad_prototype)
from srcdsp_tpu_torch.dist import comm
from srcdsp_tpu_torch.dist.halo import from_left, halo_from_left, last_tail, trailing
from srcdsp_tpu_torch.dist.mesh import TIME_AXIS, Mesh, map_shards


def _check_channels(num_channels: int, mesh: Mesh) -> None:
    p = mesh.shape[TIME_AXIS]
    if num_channels % p != 0:
        raise ValueError(f"num_channels {num_channels} not divisible by time-axis size {p}")


def all_to_all(banks, mesh: Mesh) -> tuple[torch.Tensor, ...]:
    """banks[p] [..., M, K_p] of this process's time shards -> shard q:
    [..., M/P, sum K_p] on its device, channels q*M/P .. (q+1)*M/P - 1 of
    every shard of the mesh, frames in mesh order.

    Across processes every rank holds as many shards (equal K_p): the pieces
    bound for each rank go in one ``comm.all_to_all`` and are put back in
    mesh order."""
    devices = mesh.local_devices(TIME_AXIS)
    p_all = mesh.shape[TIME_AXIS]
    w = banks[0].shape[-2] // p_all

    def piece(b, q):
        return b[..., q * w:(q + 1) * w, :]

    if not mesh.multiprocess():
        return tuple(torch.cat([piece(b, q).to(d) for b in banks], dim=-1)
                     for q, d in enumerate(devices))
    owners = mesh.axis_ranks(TIME_AXIS)
    held = [tuple(i for i, r in enumerate(owners) if r == s) for s in range(comm.world())]
    if len({len(h) for h in held}) != 1:
        raise ValueError(f"all_to_all needs as many shards on every rank, got {held}")
    mine = held[mesh.rank]
    dev = banks[0].device
    chunks = [torch.stack([piece(b, q).to(dev) for b in banks for q in held[s]])
              for s in range(comm.world())]
    got = comm.all_to_all(chunks, dev)          # got[r]: r's shards x my shards
    k = len(mine)
    out = []
    for j, d in enumerate(devices):
        parts = [got[owners[p]][held[owners[p]].index(p) * k + j] for p in range(p_all)]
        out.append(torch.cat(parts, dim=-1).to(d))
    return tuple(out)


def _bank_shards(apply, taps, tails, shards, num_channels: int, mesh: Mesh):
    banks = map_shards(lambda tail, x: apply(taps, ChannelizerState(tail=tail), x,
                                             num_channels)[1], mesh, tails, shards)
    return all_to_all(banks, mesh)


def _tail_len(taps, num_channels: int) -> int:
    return pad_prototype(taps, num_channels).shape[0] - 1


def channelize_time_sharded(taps, shards, num_channels: int, mesh: Mesh
                            ) -> tuple[torch.Tensor, ...]:
    """Shards [..., S_local] (time) -> [..., M/P, S/M] per shard (channels).

    Requires S_local % M == 0 (whole frames per shard) and M % P == 0."""
    _check_channels(num_channels, mesh)
    tails = halo_from_left(shards, _tail_len(taps, num_channels), mesh)
    return _bank_shards(channelize_apply, taps, tails, shards, num_channels, mesh)


def channelize_time_sharded_stream(taps, state_tail: torch.Tensor, shards, num_channels: int,
                                   mesh: Mesh
                                   ) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
    """Streaming form: successive time-sharded buffers channelize seamlessly.

    state_tail [..., T-1] (zeros at stream start). Returns (new tail on this
    process's first shard device, the channel shards); concatenated outputs
    across calls equal one single-device streaming run (as
    ``dist.halo.fir_time_sharded_stream``)."""
    _check_channels(num_channels, mesh)
    local = trailing(shards, _tail_len(taps, num_channels))
    ys = _bank_shards(channelize_apply, taps, from_left(local, state_tail, mesh), shards,
                      num_channels, mesh)
    return last_tail(local, mesh), ys


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
    tails = halo_from_left(shards, _tail_len(taps, num_channels), mesh)
    return _bank_shards(channelize_os2_apply, taps, tails, shards, num_channels, mesh)
