"""Halo exchange between time shards as a CUDA kernel, K19 (counterpart of
``srcdsp_tpu/kernels/halo_dma.py``).

Semantics of ``dist.halo.halo_from_left``: every shard receives its LEFT
neighbour's trailing ``halo`` columns, shard 0 receives zeros. The TPU kernel
pushes: each shard starts a remote DMA of its tail to its right neighbour
over a closed ring (the last shard also sends to shard 0, which keeps the
send and receive semaphores balanced on every device), waits, and shard 0
then overwrites what it received with zeros. Here the destination pulls, and
nothing needs balancing: one launch per destination shard p, on p's device
and current stream (``csrc/halo.cu``), reads x_{p-1}'s last columns in place
through its pointer and row stride (a peer read over NVLink when the two
shards are on two cards, a device-local read on one), and shard 0's launch
writes zeros.

Ordering instead of semaphores: before p's launch, p's stream waits on an
event recorded on p-1's stream, so x_{p-1} is complete; after it, p-1's
stream waits on an event from p's stream, so the caching allocator cannot
hand x_{p-1}'s memory out while p still reads it. On CPU tensors the wrapper
runs the plain version, ``dist.halo.halo_from_left`` (torch copies).
"""

from __future__ import annotations

import torch

from srcdsp_tpu_torch.dist.halo import halo_from_left
from srcdsp_tpu_torch.dist.mesh import device_guard
from srcdsp_tpu_torch.kernels import _build

__all__ = ["halo_from_left_pallas", "order_after"]


def order_after(consumer: torch.device, producer: torch.device) -> None:
    """Make `consumer`'s current stream wait for the work queued so far on
    `producer`'s (nothing to do when they are one stream)."""
    cs, ps = torch.cuda.current_stream(consumer), torch.cuda.current_stream(producer)
    if cs != ps:
        ev = torch.cuda.Event()
        ev.record(ps)
        cs.wait_event(ev)


def _check_shards(shards, halo: int) -> bool:
    """Validate the shards; True when they are CUDA tensors (launch the
    kernel), False for CPU tensors (the plain version)."""
    types = {x.device.type for x in shards}
    if len(types) != 1 or types - {"cuda", "cpu"}:
        raise ValueError(f"shards on {sorted(types)}: all CUDA or all CPU")
    rows = {x.shape[0] for x in shards}
    for x in shards:
        if x.ndim != 2 or x.dtype != torch.float32 or x.stride(-1) != 1:
            raise ValueError(f"shards must be [R, S] float32 with contiguous rows, got "
                             f"{tuple(x.shape)} {x.dtype} strides {x.stride()}")
        if not 0 <= halo <= x.shape[-1]:
            raise ValueError(f"halo {halo} outside a shard of {x.shape[-1]} columns")
    if len(rows) != 1:
        raise ValueError(f"shards of unequal rows {sorted(rows)}")
    return types == {"cuda"}


def halo_from_left_pallas(shards, halo: int) -> tuple[torch.Tensor, ...]:
    """shards: [R, S_p] float32 per shard (complex streams pass their planes
    as rows, R = 2), rows contiguous, any row stride -> [R, halo] per shard:
    the left neighbour's trailing `halo` columns, zeros on shard 0. Each
    output lies on its shard's device."""
    if not _check_shards(shards, halo):
        return halo_from_left(shards, halo)
    lib = _build.load()
    r = shards[0].shape[0]
    out = []
    for p, x in enumerate(shards):
        dev = x.device
        with device_guard(dev):
            o = torch.empty((r, halo), dtype=torch.float32, device=dev)
            if p:
                left = shards[p - 1]
                src = left[:, left.shape[-1] - halo:]
                order_after(dev, left.device)
            rc = lib.srcdsp_halo(src.data_ptr() if p else None, src.stride(0) if p else 0,
                                 o.data_ptr(), r, halo, dev.index, _build.stream_handle(o))
            _build.check(rc, "halo_dma")
            _build.LAUNCHES["halo_dma"] += 1
            if p:
                order_after(left.device, dev)
        out.append(o)
    return tuple(out)
