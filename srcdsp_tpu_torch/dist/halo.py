"""Overlap-save halo exchange for time-block-sharded streams (counterpart of
``srcdsp_tpu/dist/halo.py``).

A stream of length S split into P contiguous shards: every FIR or
overlap-save op needs the last ``halo`` samples of its LEFT neighbour as its
initial delay line. Shard 0 receives zeros, the causal-from-rest state, so
the time-sharded result equals the single-device result. The reference's
``lax.ppermute`` is a copy here: each shard's halo is copied to its right
neighbour's device into a buffer of its own (``halo_dma`` is the CUDA kernel
for the same exchange inside one process). Across processes the halo at a
rank boundary is a message: the rank's last shard sends its tail to the next
rank's first shard (``dist.comm.exchange``). The next buffer's carried tail,
replicated in the reference (a masked ``psum``), is broadcast from the rank
that holds the last shard (`last_tail`).

Sharded arrays are tuples of the shards this process holds, in mesh order
(`dist.mesh`).
"""

from __future__ import annotations

import torch

from srcdsp_tpu_torch.dist import comm
from srcdsp_tpu_torch.dist.mesh import TIME_AXIS, Mesh, copy_to, map_shards
from srcdsp_tpu_torch.ops.fir import complex_conv


def _local_indices(local, mesh: Mesh | None) -> tuple[int, ...]:
    if mesh is None or not mesh.multiprocess():
        return tuple(range(len(local)))
    idx = mesh.local_indices(TIME_AXIS)
    if len(idx) != len(local) or not idx:
        raise ValueError(f"{len(local)} shards for this rank's time indices {idx}")
    return idx


def from_left(local, first: torch.Tensor, mesh: Mesh | None = None
              ) -> tuple[torch.Tensor, ...]:
    """Shard p > 0 receives local[p - 1] on its device, a buffer of its own;
    shard 0 gets `first` (zeros at stream start, else the carried tail).

    Across processes (`mesh` spanning ranks), `local` holds this rank's
    shards: a left neighbour on another rank arrives by message, and this
    rank's shards whose right neighbour lies elsewhere send theirs."""
    devs = [t.device for t in local]
    idx = _local_indices(local, mesh)
    pos = {p: i for i, p in enumerate(idx)}
    owners = mesh.axis_ranks(TIME_AXIS) if mesh is not None else ()
    sends, recvs = [], []
    for i, p in enumerate(idx):
        if p + 1 < len(owners) and owners[p + 1] != mesh.rank:
            sends.append((local[i], owners[p + 1], p + 1))
        if p > 0 and p - 1 not in pos:
            recvs.append((local[i].shape, local[i].dtype, owners[p - 1], p, devs[i]))
    got = iter(comm.exchange(sends, recvs))
    out = []
    for i, p in enumerate(idx):
        if p == 0:
            out.append(first.to(devs[i]))
        elif p - 1 in pos:
            out.append(copy_to(local[pos[p - 1]], devs[i]))
        else:
            out.append(next(got))
    return tuple(out)


def last_tail(local, mesh: Mesh | None = None) -> torch.Tensor:
    """The last shard's tensor (the next buffer's carried tail) on this
    rank's first shard device, a buffer of its own: a copy in one process, a
    broadcast from the rank holding the last shard across processes."""
    device = local[0].device
    if mesh is None or not mesh.multiprocess():
        return copy_to(local[-1], device)
    _local_indices(local, mesh)
    src = mesh.axis_ranks(TIME_AXIS)[-1]
    mine = local[-1] if mesh.rank == src else None
    return comm.broadcast(mine, src, local[-1].shape, local[-1].dtype, device)


def shift_from_left(shards, mesh: Mesh | None = None) -> tuple[torch.Tensor, ...]:
    """Each shard receives its left neighbour's tensor; the first gets zeros
    (``ppermute``'s fill for an unaddressed output: the stream start)."""
    return from_left(shards, torch.zeros_like(shards[0]), mesh)


def trailing(shards, n: int) -> tuple[torch.Tensor, ...]:
    """The last n samples (trailing axis) of each shard, as views."""
    return tuple(x[..., x.shape[-1] - n:] for x in shards)


def halo_from_left(shards, halo: int, mesh: Mesh | None = None) -> tuple[torch.Tensor, ...]:
    """The last `halo` samples (trailing axis) of each shard's left neighbour."""
    return shift_from_left(trailing(shards, halo), mesh)


def _check_decim(shards, decim: int) -> None:
    for x in shards:
        if x.shape[-1] % decim != 0:
            raise ValueError(f"shard length {x.shape[-1]} not divisible by decimation {decim}")


def _fir_shards(taps, tails, shards, mesh: Mesh, decim: int):
    return map_shards(lambda tail, x: complex_conv(torch.cat([tail, x], dim=-1), taps,
                                                   stride=decim), mesh, tails, shards)


def fir_time_sharded(taps, shards, mesh: Mesh, decim: int = 1) -> tuple[torch.Tensor, ...]:
    """Causal FIR (+ decimation) over a time-sharded stream [..., S]; each
    shard's length divisible by decim. Output sharded the same way; equal to
    ``ops.fir.fir_full(taps, x, decim)`` on one device."""
    _check_decim(shards, decim)
    t = len(taps)
    return _fir_shards(taps, halo_from_left(shards, t - 1, mesh), shards, mesh, decim)


def fir_time_sharded_stream(taps, state_tail: torch.Tensor, shards, mesh: Mesh,
                            decim: int = 1) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
    """Streaming form: filter successive time-sharded buffers seamlessly.

    state_tail [..., T-1]: the previous buffer's tail (zeros at stream start,
    e.g. ``fir_init(T).tail``). Shard 0 seeds from it, every other shard from
    its left neighbour. Returns (new tail, the filtered shards); the new tail
    is the last shard's trailing T-1 samples on this process's first shard
    device (`last_tail`). Concatenated outputs across calls equal one
    single-device streaming run.
    """
    _check_decim(shards, decim)
    local = trailing(shards, len(taps) - 1)
    ys = _fir_shards(taps, from_left(local, state_tail, mesh), shards, mesh, decim)
    return last_tail(local, mesh), ys
