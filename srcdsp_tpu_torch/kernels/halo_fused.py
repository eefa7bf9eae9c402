"""Halo-fused mix + FIR + decimate over time shards, kernel K20 (counterpart
of ``srcdsp_tpu/kernels/halo_fused.py``).

The TPU kernel starts a remote DMA of its shard's trailing ``hist`` samples
to the right neighbour, computes blocks 1..G-1 while the transfer flies,
waits, and computes block 0 from the received tail. K20 computes the same
function without that schedule: it is K1's body (``csrc/mixfir.cu``) over
the ``Split`` window source of ``csrc/fsk_common.cuh``, with the history
operand read in place. For shard p > 0 that operand is the left neighbour's
``x_{p-1}[:, S - hist:]`` (a peer read when the neighbour is on another
card); for shard 0 the carried stream tail. Only row 0's block reads it; the
other blocks run as soon as they are scheduled, which is the overlap the TPU
kernel arranges by hand. No block spins on a flag raised by another kernel:
nothing guarantees the two kernels would be resident together, and the
inputs are complete before the launch (stream events order the shards, as
for K19 in ``kernels/halo_dma``).

Shard p's word is ``word0 + (p*S_local - hist)*dword`` (``dist.fused.
shard_word``), the word K1 would use for ``[tail | x_p]``, so K20 gives K1's
bits on the same stream. On CPU tensors the per-shard call runs the plain
version: the concatenation, then ``kernels.mixfir.mix_fir_plain``.

Across processes (`mix_fir_halo_sharded` on a mesh from
``dist.init_multihost`` + ``make_mesh``) each rank runs K20 on its own
shards with their global words. A boundary shard's history is its route of
``dist.ipc``: on one host the left rank pushes its last shard's tail into
the right rank's receive buffer (one K19 launch, before it waits on its own
left), and the right rank's K20 reads that buffer in place as ``x_hist``;
across hosts (and on the CPU) the tail comes by message. The carried tail
for the next buffer moves the same way, from the rank holding the last
shard to every other rank.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.dist import ipc
from srcdsp_tpu_torch.dist.fused import per_shard, shard_length, shard_word
from srcdsp_tpu_torch.dist.mesh import TIME_AXIS, Mesh, copy_to, device_guard
from srcdsp_tpu_torch.kernels import _build
from srcdsp_tpu_torch.kernels.halo_dma import launch, order_after
from srcdsp_tpu_torch.kernels.mixfir import LANE, MixFirKernel, _round_up, mix_fir_plain

__all__ = ["HaloFusedKernel", "halo_fused_plain", "make_halo_fused_kernel",
           "mix_fir_halo_sharded"]


@dataclasses.dataclass(frozen=True)
class HaloFusedKernel(MixFirKernel):
    """K20 + its layout contract. fn(word0, dword, x_hist [2, hist], x [2,
    S_local]) -> (yr, yi) [NT, OT] per shard, the reference's per-shard
    callable; planes(...) the same outputs as one [2, S_local/decim] tensor."""

    planes: Callable


def halo_fused_plain(word0, dword, x_hist: torch.Tensor, x: torch.Tensor, taps: torch.Tensor,
                     decim: int, out_tile: int, hist: int) -> torch.Tensor:
    """Plain PyTorch K20 for one shard: K1's plain version over
    ``cat(x_hist, x)`` -> planes [2, S_local/decim]."""
    yr, yi = mix_fir_plain(word0, dword, torch.cat([x_hist, x], dim=-1)[None], taps, decim,
                           out_tile, hist)
    return torch.stack([yr.reshape(-1), yi.reshape(-1)])


def make_halo_fused_kernel(taps, decim: int, out_tile: int = 128, b_rows: int = 8,
                           block_cols: int = 128, device=None) -> HaloFusedKernel:
    """Build K20. word0 is the u32 word of the shard's first history sample.
    S_local must be a multiple of b_rows*out_tile*decim and out_tile of
    block_cols, as in the reference; its TPU-only rules (b_rows % 8, out_tile
    % 128) shape the Pallas lowering and are not enforced, and its precision
    and interpret options have no counterpart. The kernel is built for
    `device`: x lies there, x_hist on it or on a card it has peer access to
    (the left neighbour's); a mesh across cards takes one kernel per card
    (``dist.mesh.per_device``)."""
    device = resolve(device)
    if out_tile % block_cols != 0:
        raise ValueError(f"out_tile {out_tile} % block_cols {block_cols} != 0")
    taps = np.asarray(taps, np.float32)
    t = taps.shape[0]
    hist = _round_up(t - 1, LANE)
    stride = out_tile * decim
    block = b_rows * stride
    h = torch.as_tensor(taps, device=device)

    def planes(word0, dword, x_hist: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        if x.ndim != 2 or x.shape[0] != 2 or tuple(x_hist.shape) != (2, hist):
            raise ValueError(f"x_hist must be [2, {hist}], x [2, S_local]; got "
                             f"{tuple(x_hist.shape)}, {tuple(x.shape)}")
        s_local = x.shape[-1]
        if s_local == 0 or s_local % block != 0:
            raise ValueError(f"S_local={s_local} not a multiple of {block}")
        for name, v in (("x", x), ("x_hist", x_hist)):
            if v.dtype != torch.float32 or v.stride(-1) != 1:
                raise ValueError(f"{name} must be float32 with contiguous planes")
        if x.device != h.device or x_hist.device.type != h.device.type:
            raise ValueError(f"x on {x.device}, x_hist on {x_hist.device}, kernel built for "
                             f"{h.device}")
        if x.device.type == "cpu":
            return halo_fused_plain(word0, dword, x_hist, x, h, decim, out_tile, hist)
        nt = s_local // stride
        y = torch.empty((2, nt * out_tile), dtype=torch.float32, device=x.device)
        rc = _build.load().srcdsp_halo_fused(
            x_hist.data_ptr(), x.data_ptr(), h.data_ptr(), y[0].data_ptr(), y[1].data_ptr(),
            int(word0), int(dword), x_hist.stride(0), x.stride(0), s_local, nt, out_tile,
            decim, t, hist, x.device.index, _build.stream_handle(x))
        _build.check(rc, "halo_fused")
        _build.LAUNCHES["halo_fused"] += 1
        return y

    def fn(word0, dword, x_hist, x):
        y = planes(word0, dword, x_hist, x)
        return y[0].view(-1, out_tile), y[1].view(-1, out_tile)

    return HaloFusedKernel(fn=fn, num_taps=t, decim=decim, out_tile=out_tile, b_rows=b_rows,
                           hist=hist, device=h.device, planes=planes)


def mix_fir_halo_sharded(kernel, word0: int, dword: int, state_tail: torch.Tensor, shards,
                         mesh: Mesh) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
    """The contract of ``dist.fused.mix_fir_time_sharded``: shards [2, S_local]
    raw planes (no history) on the mesh's time axis, state_tail [2, hist] the
    carried tail, word0 the word of the buffer's sample 0; `kernel` one
    HaloFusedKernel, or one per shard. Returns (new tail on shard 0's device,
    y [2, S_local/decim] per shard), bit-identical to K1 on [state_tail | x].
    One K20 launch per shard, no concatenation. On a mesh across processes,
    `shards` (and `kernel`) are this rank's, p counts from the mesh's first
    shard on any rank, and the new tail lands on this rank's first shard
    device, on every rank."""
    idx = mesh.local_indices(TIME_AXIS)
    devs = mesh.local_devices(TIME_AXIS)
    if tuple(x.device for x in shards) != devs:
        raise ValueError(f"shards on {[x.device for x in shards]}, mesh time axis {devs}")
    ks = per_shard(kernel, len(shards))
    s_local = shard_length(shards)
    hist = ks[0].hist
    pos = {p: i for i, p in enumerate(idx)}

    def tail(p):
        return shards[pos[p]][:, s_local - hist:]

    if mesh.multiprocess():
        route = ipc.plan(mesh, 2, hist, tail=True)
        got = route.exchange(tail)
        pushes = [(route.source(r), (tail(r.shard).data_ptr(), shards[pos[r.shard]].stride(0),
                                     route.remote[r.index])) for r in route.sends if r.ipc]
        route.send_begin()
        for dev in dict.fromkeys(d for d, _ in pushes):
            launch([e for d, e in pushes if d == dev], 2, hist, dev)
        route.send_end()
    ys = [None] * len(shards)

    def run(i, left):
        x = shards[i]
        on_card = x.device.type == "cuda"
        with device_guard(x.device):
            if on_card:
                order_after(x.device, left.device)
            ys[i] = ks[i].planes(shard_word(word0, dword, idx[i], s_local, hist), dword, left, x)
            if on_card:
                order_after(left.device, x.device)

    # shards whose history is on this rank go first: their launches run while
    # the host waits for a route's signal
    for i, p in enumerate(idx):
        if p == 0 or p - 1 in pos:
            run(i, state_tail if p == 0 else tail(p - 1))
    if mesh.multiprocess():
        route.recv_begin()
    for i, p in enumerate(idx):
        if p > 0 and p - 1 not in pos:
            run(i, route.received(p, got))
    last = mesh.shape[TIME_AXIS] - 1
    new_tail = copy_to(tail(last) if last in pos else route.received(None, got), shards[0].device)
    if mesh.multiprocess():
        route.recv_end()
    return new_tail, tuple(ys)
