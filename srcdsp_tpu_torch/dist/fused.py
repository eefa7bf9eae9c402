"""Time-sharded fused front ends: K1 and K11 on each time shard (counterpart
of ``srcdsp_tpu/dist/fused.py``).

Each shard of a time-sharded stream runs the same kernel as the single-card
path. The cross-shard glue is data:

- the history: shard p > 0 receives its left neighbour's last ``hist``
  (``overlap``) samples; shard 0 takes the carried stream tail (zeros at
  stream start);
- the NCO phase: shard p's start word is ``word0 + (p*S_local - hist)*dword``
  mod 2^32, an exact closed form (`shard_word`), so every shard mixes with
  the phase sequence one device would have used.

So the output equals the single-card kernel on ``[tail | x]`` bit for bit.
Both functions return the next buffer's tail as a buffer of its own on this
process's first shard device, never a view of the caller's buffer. A kernel
is built for one device (its call raises on another): pass one kernel when
every shard lies on that device, else one per shard
(``dist.mesh.per_device``). K20's ``kernels.halo_fused.mix_fir_halo_sharded``
takes its kernels the same way.

Across processes (a mesh from `init_multihost`), `shards` are this rank's
shards, p in `shard_word` is the shard's global index, the history at a rank
boundary arrives by message and the next tail is broadcast from the rank
holding the last shard (``dist.halo.from_left`` / ``last_tail``); each rank
passes its kernels for its own shards.
"""

from __future__ import annotations

import torch

from srcdsp_tpu_torch.dist.halo import from_left, last_tail, trailing
from srcdsp_tpu_torch.dist.mesh import TIME_AXIS, Mesh, map_shards
from srcdsp_tpu_torch.kernels.fftconv_pallas import fftconv_pallas
from srcdsp_tpu_torch.ops.nco import MASK32


def shard_word(word0: int, dword: int, p: int, s_local: int, hist: int) -> int:
    """u32 word of shard p's first history sample, for a stream whose sample
    0 has word `word0`: (word0 + (p*s_local - hist)*dword) mod 2^32, in
    exact integers (the reference's int32 wrap)."""
    return (int(word0) + (p * s_local - hist) * int(dword)) & MASK32


def per_shard(kernel, n: int) -> tuple:
    """`kernel` for each of n shards: one kernel repeated, or a sequence of n
    (one built for each shard's device)."""
    ks = tuple(kernel) if isinstance(kernel, (tuple, list)) else (kernel,) * n
    if len(ks) != n:
        raise ValueError(f"{len(ks)} kernels for {n} shards")
    return ks


def shard_length(shards) -> int:
    """The common length (trailing axis) of the shards; unequal lengths raise."""
    lengths = {x.shape[-1] for x in shards}
    if len(lengths) != 1:
        raise ValueError(f"shards of unequal lengths {sorted(lengths)}")
    return lengths.pop()


def mix_fir_time_sharded(kernel, word0: int, dword: int, state_tail: torch.Tensor, shards,
                         mesh: Mesh) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
    """K1 (``kernels.mixfir.make_mix_fir_kernel``) over a time-sharded buffer.

    shards: [2, S_local] f32 raw planes each (no history), S_local a multiple
    of kernel.block_in(); state_tail [2, hist] (zeros at stream start); word0
    the phase word of the buffer's sample 0. Returns (new tail, y [2,
    S_local/decim] per shard), bit-identical to K1 fed [state_tail | x].
    Shard p's word counts p from the mesh's first shard, on any rank.
    """
    ks = per_shard(kernel, len(shards))
    hist = ks[0].hist
    s_local = shard_length(shards)
    local = trailing(shards, hist)

    def body(p, k, tail, x):
        yr, yi = k.fn(shard_word(word0, dword, p, s_local, hist), dword,
                      torch.cat([tail, x], dim=-1))
        return torch.stack([yr.reshape(-1), yi.reshape(-1)])

    ys = map_shards(body, mesh, mesh.local_indices(TIME_AXIS), ks,
                    from_left(local, state_tail, mesh), shards)
    return last_tail(local, mesh), ys


def fftconv_time_sharded(kernel, state_tail: torch.Tensor, shards, mesh: Mesh
                         ) -> tuple[torch.Tensor, tuple[torch.Tensor, ...], tuple[torch.Tensor, ...]]:
    """K11 (``kernels.fftconv_pallas``) over a time-sharded buffer.

    shards: [C, 2, S_local] raw planes each (no history), S_local a multiple
    of kernel.block_in(); state_tail [C, 2, overlap] (zeros at stream start).
    Frames are globally seamless, so the output equals one K11 call on
    [tail | x] bit for bit. Returns (new tail, yr shards, yi shards), each
    [C, S_local].
    """
    ks = per_shard(kernel, len(shards))
    local = trailing(shards, ks[0].overlap)
    outs = map_shards(lambda k, seed, x: fftconv_pallas(k, torch.cat([seed, x], dim=-1)), mesh,
                      ks, from_left(local, state_tail, mesh), shards)
    return last_tail(local, mesh), tuple(o[0] for o in outs), tuple(o[1] for o in outs)
