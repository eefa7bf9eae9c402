"""The boundaries of a time axis between processes, and how each one moves:
the multi-process form of K19 and K20 (``kernels.halo_dma``,
``kernels.halo_fused``).

On a mesh of several processes, shard p needs the trailing ``halo`` columns
of shard p - 1. Where both lie on one rank the kernels read them in place, as
in one process. Where they lie on two ranks (the left rank L holds p - 1,
the right rank R holds p), the columns cross a process boundary. K20's
carried tail crosses too: the rank holding the last shard sends its
trailing columns to every other rank (the reference's masked ``psum``).
Each such transfer is a `Route`. Its transport follows the topology, never a
failure:

- both ranks on one host, on cards: CUDA IPC. The receiver owns a
  persistent [rows, halo] float32 buffer on its card, allocated with
  ``cudaMalloc`` and exported once (``csrc/halo.cu`` ``srcdsp_ipc_alloc``).
  The sender maps it once (``srcdsp_ipc_open``), and its K19 launch writes
  the tail into it, as the TPU kernel's remote DMA pushes it
  (``srcdsp_tpu/kernels/halo_dma.py:44-53``): over NVLink between two
  cards, device-local when both ranks share a card;
- otherwise (ranks on two hosts, or shards on the CPU): a message
  (`Plan.exchange`, ``dist.comm.exchange``), received into a buffer of its
  own, from which the kernels read the same way.

The order across processes on an IPC route takes two interprocess CUDA
events and two host signals. A stream can wait on another process's event,
but the wait binds to the last record issued before it, so each record is
followed by a signal of a few bytes over the group:

1. the sender records ``pushed`` after its push and signals the receiver;
2. the receiver takes the signal, makes its stream wait on ``pushed`` and
   reads the buffer;
3. the receiver then records ``read`` and signals back;
4. at its next push the sender takes that signal and makes its stream wait
   on ``read`` before it writes the buffer again.

The host never waits for the card here: only streams wait on events.

A plan for one (mesh, rows, halo) is built once, by every rank of the mesh
in the same order (the kernels build theirs at their first call on a mesh).
Where a route uses IPC, the build is a collective that exchanges the handles,
like `make_mesh`'s exchange of device names. `release` is collective too:
it drains the last signals, closes the mapped buffers, and frees the
exported ones after a barrier. The workers call it before
``destroy_process_group``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import time

import torch
import torch.distributed as dist

from srcdsp_tpu_torch.dist import comm
from srcdsp_tpu_torch.dist.mesh import TIME_AXIS, Mesh

__all__ = ["Plan", "Route", "SIGNALS", "export", "free", "open_handle", "plan", "release",
           "reset_signals", "routes"]

_FLOAT = 4
HANDLE_BYTES = 64           # sizeof(cudaIpcMemHandle_t)
# tags of a plan's messages and signals, apart from dist.halo's (the shard index)
_MESSAGE_TAG, _SIGNAL_TAG, _TAGS_PER_PLAN = 1 << 20, 1 << 21, 1 << 12

#: host signals taken on IPC routes: how many, and host-clock seconds spent
#: waiting for them (the receive, from its post to the peer's message)
SIGNALS = {"waits": 0, "seconds": 0.0}

_PLANS: dict[tuple, "Plan"] = {}
_OPENED: dict[tuple[int, bytes], tuple[int, int]] = {}   # (owner rank, handle) -> (ptr, device)


@dataclasses.dataclass(frozen=True)
class Route:
    """The trailing columns of time shard `shard` (on rank `src`) go to rank
    `dst`: for shard `to`, or, with `to` None, as the carried tail (to dst's
    first shard). `ipc`: by CUDA IPC, else by message."""

    index: int
    src: int
    dst: int
    shard: int
    to: int | None
    ipc: bool


def routes(mesh: Mesh, tail: bool = False) -> tuple[Route, ...]:
    """The routes of a mesh's time axis, the same list on every rank: one per
    boundary between two ranks, then (with `tail`) one from the rank holding
    the last shard to each other rank that holds a shard."""
    owners, devs = mesh.axis_ranks(TIME_AXIS), mesh.axis_devices(TIME_AXIS)
    out = []

    def add(shard, to, dst, dst_device):
        src = owners[shard]
        ipc = (mesh.same_host(src, dst) and devs[shard].type == "cuda"
               and dst_device.type == "cuda")
        out.append(Route(len(out), src, dst, shard, to, ipc))

    for p in range(1, len(owners)):
        if owners[p - 1] != owners[p]:
            add(p - 1, p, owners[p], devs[p])
    if tail:
        last = len(owners) - 1
        for r in sorted(set(owners) - {owners[last]}):
            add(last, None, r, devs[owners.index(r)])
    return tuple(out)


def reset_signals() -> None:
    SIGNALS.update(waits=0, seconds=0.0)


def _lib():
    from srcdsp_tpu_torch.kernels import _build

    return _build.load()


def _fail(rc: int, what: str) -> None:
    if rc != 0:
        from srcdsp_tpu_torch.kernels import _build

        raise RuntimeError(f"{what}: {_build.error_name(rc)} (cudaError_t {rc})")


def export(nbytes: int, device: torch.device) -> tuple[int, bytes]:
    """A zeroed cudaMalloc allocation of `nbytes` on `device` and its IPC
    handle: (pointer, 64 handle bytes). Free it with `free`."""
    ptr, handle = ctypes.c_void_p(), ctypes.create_string_buffer(HANDLE_BYTES)
    _fail(_lib().srcdsp_ipc_alloc(nbytes, device.index, ctypes.byref(ptr), handle),
          f"cudaIpcGetMemHandle of {nbytes} bytes on {device}")
    return ptr.value, handle.raw


def free(ptr: int, device: torch.device) -> None:
    _fail(_lib().srcdsp_ipc_free(ptr, device.index), f"cudaFree of an exported buffer on {device}")


def open_handle(handle: bytes, device: torch.device, owner: int) -> int:
    """Rank `owner`'s exported allocation mapped into this process for the
    kernels of `device`: its pointer here. A handle opens once per process
    (the mapping is kept until `release`), and never in the process that
    exported it: that raises, naming the CUDA error."""
    key = (owner, handle)
    if key not in _OPENED:
        ptr = ctypes.c_void_p()
        _fail(_lib().srcdsp_ipc_open(ctypes.create_string_buffer(handle, HANDLE_BYTES),
                                     device.index, ctypes.byref(ptr)),
              f"cudaIpcOpenMemHandle of rank {owner}'s buffer on {device}")
        _OPENED[key] = (ptr.value, device.index)
    return _OPENED[key][0]


class _Raw:
    """A [rows, halo] float32 view of raw device memory for ``torch.as_tensor``."""

    def __init__(self, ptr: int, shape: tuple[int, int]):
        self.__cuda_array_interface__ = dict(shape=shape, typestr="<f4", data=(ptr, False),
                                             strides=None, version=2)


def _event(device: torch.device) -> tuple[torch.cuda.Event, bytes]:
    with torch.cuda.device(device):
        ev = torch.cuda.Event(interprocess=True)
        return ev, ev.ipc_handle()


class Plan:
    """The routes of one (mesh, rows, halo) as this rank sees them, with the
    buffers, mapped pointers and events of its IPC routes (built by `plan`).

    `exchange` moves the message routes. On the IPC routes a step runs
    `send_begin`, the push (a K19 launch writing to `remote`), `send_end`;
    and `recv_begin`, the reads of `received`, `recv_end`; K19 calls both
    begins before its one launch, K20 pushes before it waits on its left."""

    def __init__(self, mesh: Mesh, rows: int, halo: int, tail: bool, serial: int):
        self.mesh, self.rows, self.halo = mesh, rows, halo
        self.routes = routes(mesh, tail)
        self.sends = tuple(r for r in self.routes if r.src == mesh.rank)
        self.recvs = tuple(r for r in self.routes if r.dst == mesh.rank)
        self._tag = serial * _TAGS_PER_PLAN
        self.buffers: dict[int, torch.Tensor] = {}   # route -> this rank's exported buffer
        self.remote: dict[int, int] = {}             # route -> the mapped receive buffer
        self._exported: list[tuple[int, torch.device]] = []
        self._pushed: dict[int, torch.cuda.Event] = {}
        self._read: dict[int, torch.cuda.Event] = {}
        self._count = {r.index: 0 for r in self.sends + self.recvs}
        self._owed: set[int] = set()                 # sends whose back signal is still due
        self._pending: list = []                     # (work, tensor) of signals in flight
        if any(r.ipc for r in self.routes):
            self._connect()

    def device(self, r: Route) -> torch.device:
        """The device a route's data ends on (as its receiver names it)."""
        owners, devs = self.mesh.axis_ranks(TIME_AXIS), self.mesh.axis_devices(TIME_AXIS)
        return devs[r.to] if r.to is not None else devs[owners.index(r.dst)]

    def source(self, r: Route) -> torch.device:
        return self.mesh.axis_devices(TIME_AXIS)[r.shard]

    def _connect(self) -> None:
        """Export this rank's receive buffers and events, gather every rank's
        handles, and open the ones this rank uses (a collective)."""
        mine = {}
        for r in self.recvs:
            if r.ipc:
                dev = self.device(r)
                ptr, handle = export(self.rows * self.halo * _FLOAT, dev)
                self._exported.append((ptr, dev))
                with torch.cuda.device(dev):
                    buf = torch.as_tensor(_Raw(ptr, (self.rows, self.halo)), device=dev)
                if buf.data_ptr() != ptr:
                    raise RuntimeError(f"the view of route {r.index}'s buffer is a copy")
                self.buffers[r.index] = buf
                self._read[r.index], read = _event(dev)
                mine[r.index] = (handle, read)
        for r in self.sends:
            if r.ipc:
                self._pushed[r.index], mine[r.index] = _event(self.source(r))
        everyone = [None] * comm.world()
        dist.all_gather_object(everyone, mine)
        for r in self.sends:
            if r.ipc:
                handle, read = everyone[r.dst][r.index]
                dev = self.source(r)
                self.remote[r.index] = open_handle(handle, dev, r.dst)
                self._read[r.index] = torch.cuda.Event.from_ipc_handle(dev, read)
        for r in self.recvs:
            if r.ipc:
                self._pushed[r.index] = torch.cuda.Event.from_ipc_handle(
                    self.device(r), everyone[r.src][r.index])

    # --- message routes ------------------------------------------------------

    def exchange(self, tail_of) -> dict[int, torch.Tensor]:
        """Send the message routes' columns (`tail_of(shard)`: this rank's
        shard's trailing [rows, halo]) and receive this rank's: {route index:
        a buffer of its own on the route's device}."""
        sends = [(tail_of(r.shard), r.dst, _MESSAGE_TAG + self._tag + r.index)
                 for r in self.sends if not r.ipc]
        recvs = [r for r in self.recvs if not r.ipc]
        got = comm.exchange(sends, [((self.rows, self.halo), torch.float32, r.src,
                                     _MESSAGE_TAG + self._tag + r.index, self.device(r))
                                    for r in recvs])
        return {r.index: t for r, t in zip(recvs, got)}

    def received(self, to: int | None, got: dict[int, torch.Tensor]) -> torch.Tensor:
        """What this rank receives for shard `to` (None: the carried tail):
        the IPC buffer, or the message from `exchange`."""
        for r in self.recvs:
            if r.to == to:
                return self.buffers[r.index] if r.ipc else got[r.index]
        raise KeyError(f"rank {self.mesh.rank} receives nothing for shard {to}")

    # --- the order on the IPC routes -----------------------------------------

    def _signal(self, peer: int, tag: int, n: int) -> None:
        self._pending = [(w, t) for w, t in self._pending if not w.is_completed()]
        t = torch.tensor([n], dtype=torch.int64)
        self._pending.append((dist.isend(t, peer, tag=_SIGNAL_TAG + self._tag + tag), t))

    def _await(self, peer: int, tag: int, n: int) -> None:
        t = torch.empty(1, dtype=torch.int64)
        t0 = time.perf_counter()
        dist.recv(t, peer, tag=_SIGNAL_TAG + self._tag + tag)
        SIGNALS["waits"] += 1
        SIGNALS["seconds"] += time.perf_counter() - t0
        if int(t) != n:
            raise RuntimeError(f"IPC route signal out of step: got {int(t)} from rank {peer}, "
                               f"expected {n}")

    def send_begin(self) -> None:
        """Before a push: each buffer's previous contents have been read."""
        for r in self.sends:
            if r.ipc and r.index in self._owed:
                self._await(r.dst, 2 * r.index + 1, self._count[r.index] - 1)
                self._owed.discard(r.index)
                self._read[r.index].wait(torch.cuda.current_stream(self.source(r)))

    def send_end(self) -> None:
        """After a push: record `pushed` and signal each receiver."""
        for r in self.sends:
            if r.ipc:
                self._pushed[r.index].record(torch.cuda.current_stream(self.source(r)))
                self._signal(r.dst, 2 * r.index, self._count[r.index])
                self._owed.add(r.index)
                self._count[r.index] += 1

    def recv_begin(self) -> None:
        """Before the reads: each buffer holds this step's push."""
        for r in self.recvs:
            if r.ipc:
                self._await(r.src, 2 * r.index, self._count[r.index])
                self._pushed[r.index].wait(torch.cuda.current_stream(self.device(r)))

    def recv_end(self) -> None:
        """After the reads: record `read` and signal each sender."""
        for r in self.recvs:
            if r.ipc:
                self._read[r.index].record(torch.cuda.current_stream(self.device(r)))
                self._signal(r.src, 2 * r.index + 1, self._count[r.index])
                self._count[r.index] += 1

    def _drain(self) -> None:
        for r in self.sends:
            if r.index in self._owed:
                self._await(r.dst, 2 * r.index + 1, self._count[r.index] - 1)
        self._owed.clear()
        for w, _ in self._pending:
            w.wait()
        self._pending = []


def plan(mesh: Mesh, rows: int, halo: int, tail: bool = False) -> Plan:
    """The plan of (mesh, rows, halo), built at its first request: every rank
    of the mesh requests its plans in the same order."""
    key = (mesh, rows, halo, tail)
    if key not in _PLANS:
        _PLANS[key] = Plan(mesh, rows, halo, tail, len(_PLANS))
    return _PLANS[key]


def release() -> None:
    """Drain every plan's signals, close the mapped buffers, then (after a
    barrier, so no rank still maps them) free this rank's exported buffers.
    Collective over the ranks that built plans; a no-op without one."""
    plans = list(_PLANS.values())
    _PLANS.clear()
    for p in plans:
        p._drain()
    ipc = any(r.ipc for p in plans for r in p.routes)
    if ipc:
        for p in plans:
            for dev in {d for _, d in p._exported} | {p.source(r) for r in p.sends if r.ipc}:
                torch.cuda.synchronize(dev)
    for (owner, _), (ptr, index) in list(_OPENED.items()):
        _fail(_lib().srcdsp_ipc_close(ptr, index),
              f"cudaIpcCloseMemHandle of rank {owner}'s buffer on cuda:{index}")
    _OPENED.clear()
    if ipc:
        dist.barrier()
    for p in plans:
        p.buffers.clear()
        for ptr, dev in p._exported:
            free(ptr, dev)
        p._exported.clear()

