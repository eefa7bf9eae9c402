"""Messages between processes for the distribution tier.

The reference's collectives (``ppermute``, ``psum`` of a masked tail,
``all_to_all``, ``process_allgather``) cross the process boundary through
``torch.distributed``, set up by `dist.mesh.init_multihost`. This module
holds the few transfers the tier needs: point-to-point sends (the halo),
a broadcast (the stream tail), an all-to-all of equal chunks (the
channelizer's re-shard) and an all-gather (gathering a result).

Backends, chosen by the caller and never switched here:

- ``nccl``: one card per rank; card tensors go to NCCL as they are, and a
  CPU tensor raises;
- ``gloo``: CPU tensors as they are. gloo sends no CUDA tensor, so a card
  tensor goes through the host: `to_host` copies it out and `from_host`
  copies a received one in, each counted in `STAGED` (bytes, copies and
  seconds of host clock around the synchronous copy). Nothing else moves a
  card tensor to the host.

Every wait has the time limit of the process group (`init_multihost`'s
``timeout``): a dead peer raises instead of hanging.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

#: bytes, copies and seconds of host staging under gloo (card <-> host)
STAGED = {"bytes": 0, "copies": 0, "seconds": 0.0}


def reset_staged() -> None:
    STAGED.update(bytes=0, copies=0, seconds=0.0)


def active() -> bool:
    """True once `init_multihost` has joined this process to a group."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world() -> int:
    return dist.get_world_size() if active() else 1


def uses_nccl() -> bool:
    """True when the group moves card tensors through NCCL (one card a rank)."""
    return "nccl" in str(dist.get_backend()) if active() else False


def _count(t: torch.Tensor, t0: float) -> None:
    STAGED["bytes"] += t.numel() * t.element_size()
    STAGED["copies"] += 1
    STAGED["seconds"] += time.perf_counter() - t0


def to_host(t: torch.Tensor) -> torch.Tensor:
    """A card tensor copied to the host for gloo, counted; a CPU tensor as a
    contiguous tensor (no copy when it is one)."""
    if t.device.type != "cuda":
        return t.contiguous()
    t0 = time.perf_counter()
    h = t.to("cpu")                       # synchronous: the bytes are on the host
    _count(h, t0)
    return h


def from_host(h: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A received host tensor on `device`: a counted copy onto a card, the
    tensor itself on the CPU."""
    if device.type != "cuda":
        return h
    t0 = time.perf_counter()
    out = h.to(device)
    torch.cuda.synchronize(device)
    _count(h, t0)
    return out


def on_wire(t: torch.Tensor) -> torch.Tensor:
    """`t` as the backend takes it: itself (contiguous) on a card under NCCL,
    staged to the host under gloo. A CPU tensor under NCCL raises."""
    if uses_nccl():
        if t.device.type != "cuda":
            raise ValueError(f"nccl moves card tensors only, got one on {t.device}")
        return t.contiguous()
    return to_host(t)


def wire_empty(shape, dtype, device: torch.device) -> torch.Tensor:
    """A receive buffer: on `device` under NCCL, on the host under gloo."""
    return torch.empty(shape, dtype=dtype, device=device if uses_nccl() else "cpu")


def off_wire(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A received tensor on `device` (`from_host` under gloo)."""
    return t if uses_nccl() else from_host(t, device)


def exchange(sends, recvs) -> list[torch.Tensor]:
    """Point-to-point: sends [(tensor, dst rank, tag)], recvs [(shape, dtype,
    src rank, tag, device)] -> the received tensors on their devices, in
    the order of `recvs`. Both sides list a pair's messages in one order."""
    ops, bufs = [], []
    for t, dst, tag in sends:
        ops.append(dist.P2POp(dist.isend, on_wire(t), dst, tag=tag))
    for shape, dtype, src, tag, device in recvs:
        b = wire_empty(shape, dtype, device)
        bufs.append((b, device))
        ops.append(dist.P2POp(dist.irecv, b, src, tag=tag))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return [off_wire(b, d) for b, d in bufs]


def broadcast(t: torch.Tensor | None, src: int, shape, dtype, device: torch.device
              ) -> torch.Tensor:
    """Rank `src`'s tensor on every rank, on `device` (a buffer of its own)."""
    if rank() == src:
        buf = on_wire(t)
        if buf is t:
            buf = t.clone()
    else:
        buf = wire_empty(shape, dtype, device)
    dist.broadcast(buf, src)
    return off_wire(buf, device)


def all_to_all(chunks: list[torch.Tensor], device: torch.device) -> list[torch.Tensor]:
    """chunks[s]: what this rank sends to rank s, equal shapes on every rank
    -> what each rank sent to this one, in rank order, on `device`."""
    send = torch.stack([c.contiguous() for c in chunks])
    send = on_wire(send)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send)
    return list(off_wire(recv, device).unbind(0))


def all_gather(t: torch.Tensor, device: torch.device) -> list[torch.Tensor]:
    """Every rank's `t` (equal shapes), in rank order, on `device`."""
    send = on_wire(t)
    out = [torch.empty_like(send) for _ in range(world())]
    dist.all_gather(out, send)
    return list(off_wire(torch.stack(out), device).unbind(0))
