"""Overlap-save halo exchange for time-block-sharded streams (counterpart of
``srcdsp_tpu/dist/halo.py``).

A stream of length S split into P contiguous shards: every FIR or
overlap-save op needs the last ``halo`` samples of its LEFT neighbour as its
initial delay line. Shard 0 receives zeros, the causal-from-rest state, so
the time-sharded result equals the single-device result. The reference's
``lax.ppermute`` is a copy here: each shard's halo is copied to its right
neighbour's device into a buffer of its own (``halo_dma`` is the CUDA kernel
for the same exchange).

Sharded arrays are tuples of per-shard tensors in mesh order (`dist.mesh`).
"""

from __future__ import annotations

import torch

from srcdsp_tpu_torch.dist.mesh import Mesh, copy_to, map_shards
from srcdsp_tpu_torch.ops.fir import complex_conv


def from_left(local, first: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Shard p > 0 receives local[p - 1], copied to its device; shard 0 gets
    `first` (zeros at stream start, else the carried tail), on its device."""
    devs = [t.device for t in local]
    return (first.to(devs[0]),) + tuple(copy_to(local[p - 1], devs[p])
                                       for p in range(1, len(local)))


def shift_from_left(shards) -> tuple[torch.Tensor, ...]:
    """Each shard receives its left neighbour's tensor; the first gets zeros
    (``ppermute``'s fill for an unaddressed output: the stream start)."""
    return from_left(shards, torch.zeros_like(shards[0]))


def trailing(shards, n: int) -> tuple[torch.Tensor, ...]:
    """The last n samples (trailing axis) of each shard, as views."""
    return tuple(x[..., x.shape[-1] - n:] for x in shards)


def halo_from_left(shards, halo: int) -> tuple[torch.Tensor, ...]:
    """The last `halo` samples (trailing axis) of each shard's left neighbour."""
    return shift_from_left(trailing(shards, halo))


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
    return _fir_shards(taps, halo_from_left(shards, t - 1), shards, mesh, decim)


def fir_time_sharded_stream(taps, state_tail: torch.Tensor, shards, mesh: Mesh,
                            decim: int = 1) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
    """Streaming form: filter successive time-sharded buffers seamlessly.

    state_tail [..., T-1]: the previous buffer's tail (zeros at stream start,
    e.g. ``fir_init(T).tail``). Shard 0 seeds from it, every other shard from
    its left neighbour. Returns (new tail, the filtered shards); the new tail
    is the last shard's trailing T-1 samples, copied to shard 0's device.
    Concatenated outputs across calls equal one single-device streaming run.
    """
    _check_decim(shards, decim)
    local = trailing(shards, len(taps) - 1)
    ys = _fir_shards(taps, from_left(local, state_tail), shards, mesh, decim)
    return copy_to(local[-1], shards[0].device), ys
