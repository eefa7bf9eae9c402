"""Halo exchange between time shards as a CUDA kernel, K19 (counterpart of
``srcdsp_tpu/kernels/halo_dma.py``).

Semantics of ``dist.halo.halo_from_left``: every shard receives its LEFT
neighbour's trailing ``halo`` columns, shard 0 receives zeros. The TPU kernel
pushes: each shard starts a remote DMA of its tail to its right neighbour
over a closed ring (the last shard also sends to shard 0, which keeps the
send and receive semaphores balanced on every device), waits, and shard 0
then overwrites what it received with zeros. Here the destination pulls, and
nothing needs balancing: one launch per device (``csrc/halo.cu``) serves
every destination shard on that device, on its current stream, each entry
of a table passed by value reading x_{p-1}'s last columns in place through
its pointer and row stride (a peer read over NVLink when the two shards are
on two cards, a device-local read on one), shard 0's entry writing zeros.
On one card a call is one launch, whatever the number of shards.

The grouping and the table depend only on the shards' devices, shapes and
row strides (`halo_plan`); they are built once for each such layout and
kept, so a call only writes its pointers into the table. The outputs of one
device are the [R, halo] slices of one [P_d, R, halo] buffer.

Ordering instead of semaphores, between distinct streams only: before a
device's launch its stream waits on an event recorded on the stream of each
other device whose shards it reads, so those are complete; after it, each of
those streams waits on an event from the reader's, so the caching allocator
cannot hand a left shard's memory out while it is still read. On CPU tensors
the wrapper runs the plain version, ``dist.halo.halo_from_left`` (torch
copies).

Across processes (a `mesh` from ``dist.init_multihost`` + ``make_mesh``),
each rank passes its own shards, and a left neighbour on another rank is a
route of ``dist.ipc``. On one host the left rank pushes, as the TPU kernel
does: its launch carries one more table entry, whose output is the right
rank's receive buffer mapped into this process by CUDA IPC, and the right
rank's launch then reads that buffer as a local source. Across hosts the
columns come by message into a buffer of their own, and the launch reads
that; on CPU shards the plain version, ``dist.halo.halo_from_left`` with the
mesh, sends them by message too. Interprocess events and host signals order
the two ranks (``dist.ipc``); within a rank the order is as above.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from srcdsp_tpu_torch.dist import ipc
from srcdsp_tpu_torch.dist.halo import halo_from_left
from srcdsp_tpu_torch.dist.mesh import TIME_AXIS, Mesh
from srcdsp_tpu_torch.kernels import _build

__all__ = ["HaloGroup", "HALO_MAX_ENTRIES", "halo_from_left_pallas", "halo_plan", "launch",
           "order_after"]

HALO_MAX_ENTRIES = 64  # kHaloMaxEntries of csrc/halo.cu: destination shards per launch
_FLOAT = 4


def order_after(consumer: torch.device, producer: torch.device) -> None:
    """Make `consumer`'s current stream wait for the work queued so far on
    `producer`'s (nothing to do when they are one stream)."""
    cs, ps = torch.cuda.current_stream(consumer), torch.cuda.current_stream(producer)
    if cs != ps:
        ev = torch.cuda.Event()
        ev.record(ps)
        cs.wait_event(ev)


@dataclasses.dataclass(frozen=True)
class HaloGroup:
    """The destination shards on one device, served by one launch: entry i
    is shard ``shards[i]``, reading shard ``lefts[i]`` (None for shard 0:
    zeros) from byte ``offsets[i]`` of its data with row stride
    ``strides[i]`` floats. ``producers``: the other devices whose shards it
    reads, in first-use order."""

    device: torch.device
    shards: tuple[int, ...]
    lefts: tuple[int | None, ...]
    offsets: tuple[int, ...]
    strides: tuple[int, ...]
    producers: tuple[torch.device, ...]


def halo_plan(devices, shapes, strides, halo: int) -> tuple[HaloGroup, ...]:
    """Group the destination shards by device (in the order the devices first
    appear) from the shards' devices, [R, S_p] shapes and row strides alone;
    more than HALO_MAX_ENTRIES shards on one device raise."""
    groups: dict[torch.device, list[int]] = {}
    for p, d in enumerate(devices):
        groups.setdefault(d, []).append(p)
    plan = []
    for dev, ps in groups.items():
        if len(ps) > HALO_MAX_ENTRIES:
            raise ValueError(f"{len(ps)} shards on {dev}: one launch serves at most "
                             f"{HALO_MAX_ENTRIES}")
        lefts = tuple(p - 1 if p else None for p in ps)
        producers = []
        for q in lefts:
            if q is not None and devices[q] != dev and devices[q] not in producers:
                producers.append(devices[q])
        plan.append(HaloGroup(
            device=dev, shards=tuple(ps), lefts=lefts,
            offsets=tuple(0 if q is None else (shapes[q][-1] - halo) * _FLOAT for q in lefts),
            strides=tuple(0 if q is None else strides[q] for q in lefts),
            producers=tuple(producers)))
    return tuple(plan)


@functools.lru_cache(maxsize=64)
def _launch_plan(layout: tuple, halo: int):
    """Validate the shards' layout ((device, shape, strides, dtype) per
    shard) once; None for CPU shards (the plain version), else halo_plan's
    groups, each with its ctypes table ({src, stride, out} per entry) made
    once and its strides filled in; a call rewrites the table's pointers, so
    calls on one layout come from one thread at a time."""
    types = {d.type for d, _, _, _ in layout}
    if len(types) != 1 or types - {"cuda", "cpu"}:
        raise ValueError(f"shards on {sorted(types)}: all CUDA or all CPU")
    for _, shape, strides, dtype in layout:
        if len(shape) != 2 or dtype != torch.float32 or strides[-1] != 1:
            raise ValueError(f"shards must be [R, S] float32 with contiguous rows, got "
                             f"{tuple(shape)} {dtype} strides {strides}")
        if not 0 <= halo <= shape[-1]:
            raise ValueError(f"halo {halo} outside a shard of {shape[-1]} columns")
    rows = {shape[0] for _, shape, _, _ in layout}
    if len(rows) != 1:
        raise ValueError(f"shards of unequal rows {sorted(rows)}")
    if types == {"cpu"}:
        return None
    out = []
    for g in halo_plan(*zip(*((d, shape, strides[0]) for d, shape, strides, _ in layout)), halo):
        table = (ctypes.c_longlong * (3 * len(g.shards)))()
        table[1::3] = list(g.strides)
        out.append((g, table))
    return tuple(out)


def launch(entries, rows: int, halo: int, device: torch.device) -> None:
    """One K19 launch on `device`'s current stream over `entries`, (src
    pointer or 0 for zeros, src row stride in floats, out pointer) each: the
    form that carries pushes into another process's mapped buffer."""
    if not 0 < len(entries) <= HALO_MAX_ENTRIES:
        raise ValueError(f"{len(entries)} entries: one launch serves 1 to {HALO_MAX_ENTRIES}")
    table = (ctypes.c_longlong * (3 * len(entries)))(*(v for e in entries for v in e))
    rc = _build.load().srcdsp_halo(ctypes.addressof(table), len(entries), rows, halo,
                                   device.index, _build.stream_handle(device))
    _build.check(rc, "halo_dma")
    _build.LAUNCHES["halo_dma"] += 1


def halo_from_left_pallas(shards, halo: int, mesh: Mesh | None = None
                          ) -> tuple[torch.Tensor, ...]:
    """shards: [R, S_p] float32 per shard (complex streams pass their planes
    as rows, R = 2), rows contiguous, any row stride -> [R, halo] per shard:
    the left neighbour's trailing `halo` columns, zeros on shard 0. Each
    output lies on its shard's device. One launch per device.

    The host work of a call is the layout key, one allocation and one launch
    per device: the device is named explicitly (the allocation, the stream
    handle, and the C entry point's DeviceScope), so no device guard is
    needed. With a `mesh` across processes, `shards` are this rank's time
    shards, in mesh order (`_across`); with none, or a mesh of one process,
    the call is as above."""
    plan = _launch_plan(tuple((x.device, x.shape, x.stride(), x.dtype) for x in shards), halo)
    if plan is None:
        return halo_from_left(shards, halo, mesh)
    if mesh is not None and mesh.multiprocess():
        return _across(shards, halo, mesh)
    lib = _build.load()
    r = shards[0].shape[0]
    out = [None] * len(shards)
    for g, table in plan:
        buf = torch.empty((len(g.shards), r, halo), dtype=torch.float32, device=g.device)
        at, step = buf.data_ptr(), r * halo * _FLOAT
        for i, (q, off) in enumerate(zip(g.lefts, g.offsets)):
            table[3 * i] = 0 if q is None else shards[q].data_ptr() + off
            table[3 * i + 2] = at + i * step
        for d in g.producers:
            order_after(g.device, d)
        rc = lib.srcdsp_halo(ctypes.addressof(table), len(g.shards), r, halo, g.device.index,
                             _build.stream_handle(buf))
        _build.check(rc, "halo_dma")
        _build.LAUNCHES["halo_dma"] += 1
        for d in g.producers:
            order_after(d, g.device)
        for p, o in zip(g.shards, buf.unbind(0)):
            out[p] = o
    return tuple(out)


def _across(shards, halo: int, mesh: Mesh) -> tuple[torch.Tensor, ...]:
    """K19 on this rank's card shards of a mesh across processes: local lefts
    in place, a left on another rank from its route (``dist.ipc``: the IPC
    receive buffer, or the message), and this rank's pushes into the right
    ranks' buffers in the same launch."""
    idx = mesh.local_indices(TIME_AXIS)
    if tuple(x.device for x in shards) != mesh.local_devices(TIME_AXIS) or not idx:
        raise ValueError(f"shards on {[x.device for x in shards]}, this rank's time devices "
                         f"{mesh.local_devices(TIME_AXIS)}")
    pos = {p: i for i, p in enumerate(idx)}
    rows = shards[0].shape[0]

    def tail(p):
        x = shards[pos[p]]
        return x[:, x.shape[-1] - halo:]

    route = ipc.plan(mesh, rows, halo)
    got = route.exchange(tail)
    groups: dict[torch.device, list] = {}
    producers: dict[torch.device, set] = {}
    out = []
    for p, x in zip(idx, shards):
        o = torch.empty((rows, halo), dtype=torch.float32, device=x.device)
        out.append(o)
        if p == 0:
            src = (0, 0)
        elif p - 1 in pos:
            left = shards[pos[p - 1]]
            src = (tail(p - 1).data_ptr(), left.stride(0))
            if left.device != x.device:
                producers.setdefault(x.device, set()).add(left.device)
        else:
            src = (route.received(p, got).data_ptr(), halo)
        groups.setdefault(x.device, []).append((*src, o.data_ptr()))
    for r in route.sends:
        if r.ipc:
            x = shards[pos[r.shard]]
            groups[x.device].append((tail(r.shard).data_ptr(), x.stride(0), route.remote[r.index]))
    route.send_begin()
    route.recv_begin()
    for dev, entries in groups.items():
        for d in producers.get(dev, ()):
            order_after(dev, d)
        launch(entries, rows, halo, dev)
        for d in producers.get(dev, ()):
            order_after(d, dev)
    route.recv_end()
    route.send_end()
    return tuple(out)
