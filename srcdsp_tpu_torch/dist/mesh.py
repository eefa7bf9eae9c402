"""Device meshes and sharded arrays (counterpart of ``srcdsp_tpu/dist/mesh.py``).

Axis names are fixed: ``time`` for time-block (sequence) parallelism,
``channel`` for channel (data) parallelism. A mesh is a [time, channel] grid
of ``torch.device``s. A device may repeat, so P shards can sit on one card
(or on the CPU) as P virtual devices, as the reference's tests run on 8
virtual CPU devices: the halo still moves between shard buffers, and only a
transfer's time needs two cards. Where a mesh holds two cards of one
process, each pair gets peer access (``csrc/halo.cu``), so a kernel on one
card reads the other's memory; a pair without it raises.

The port has no global sharded array: a sharded array is a tuple of
per-shard tensors in mesh order, each on its shard's device (`shard`,
`unshard`). `map_shards` runs a body with no collective on every shard, the
``shard_map`` counterpart for such bodies.

Across processes (`init_multihost`, the counterpart of
``jax.distributed.initialize``), `make_mesh` lays the grid over every rank's
local devices in rank order, as the reference's process-major
``jax.devices()``; each position knows the rank that holds it. A sharded
array is then the tuple of the shards this rank holds, in mesh order
(`time_sharding` / `channel_sharding` name their global indices), and the
glue that is a copy inside one process becomes a message (``dist.comm``):
`local_shards` is ``host_local_array_to_global_array``'s counterpart and
`process_allgather` gathers a sharded result onto every rank. In one
process all of this reduces to `shard`, `unshard` and `map_shards`. The
mesh also records each rank's host (`Mesh.hosts`), so a boundary between
two ranks moves by CUDA IPC where both lie on one host and by message
where they do not (``dist.ipc``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import socket
from typing import Callable, ClassVar

import torch
import torch.distributed as dist

from srcdsp_tpu_torch.device import resolve

TIME_AXIS = "time"
CHANNEL_AXIS = "channel"
BACKENDS = ("gloo", "nccl")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """devices[p][q]: the shard at time index p and channel index q;
    ranks[p][q] the process that holds it (None: every shard in this
    process, `rank` 0). A device of another rank is as that rank named it.
    hosts[r]: the host name of rank r (None: one process)."""

    devices: tuple[tuple[torch.device, ...], ...]
    ranks: tuple[tuple[int, ...], ...] | None = None
    rank: int = 0
    hosts: tuple[str, ...] | None = None
    axis_names: ClassVar[tuple[str, str]] = (TIME_AXIS, CHANNEL_AXIS)

    @property
    def shape(self) -> dict[str, int]:
        return {TIME_AXIS: len(self.devices), CHANNEL_AXIS: len(self.devices[0])}

    def _axis(self, grid, axis: str) -> tuple:
        if axis == TIME_AXIS:
            return tuple(row[0] for row in grid)
        if axis == CHANNEL_AXIS:
            return tuple(grid[0])
        raise ValueError(f"axis {axis!r} not in {self.axis_names}")

    def axis_devices(self, axis: str = TIME_AXIS) -> tuple[torch.device, ...]:
        """The devices along `axis` (at index 0 of the other axis)."""
        return self._axis(self.devices, axis)

    def axis_ranks(self, axis: str = TIME_AXIS) -> tuple[int, ...]:
        """The rank holding each position along `axis`."""
        if self.ranks is None:
            return (self.rank,) * self.shape[axis]
        return self._axis(self.ranks, axis)

    def local_indices(self, axis: str = TIME_AXIS) -> tuple[int, ...]:
        """The global indices along `axis` that this process holds."""
        return tuple(i for i, r in enumerate(self.axis_ranks(axis)) if r == self.rank)

    def local_devices(self, axis: str = TIME_AXIS) -> tuple[torch.device, ...]:
        """This process's devices along `axis`, in mesh order."""
        devs = self.axis_devices(axis)
        return tuple(devs[i] for i in self.local_indices(axis))

    def multiprocess(self) -> bool:
        """True when the mesh spans more than one process."""
        return self.ranks is not None and len({r for row in self.ranks for r in row}) > 1

    def same_host(self, a: int, b: int) -> bool:
        """True when ranks a and b run on one host."""
        return self.hosts is None or self.hosts[a] == self.hosts[b]


def init_multihost(coordinator: str | None = None, num_processes: int | None = None,
                   process_id: int | None = None, backend: str | None = None,
                   device=None, timeout: float = 300.0) -> None:
    """Join this process to a group of `num_processes` ranks; call once per
    process before `make_mesh` (the counterpart of the reference's
    ``jax.distributed.initialize``).

    Nothing is detected: there is no metadata server, so the address
    (``tcp://host:port``, or ``file://path`` on one host; a bare ``host:port``
    means tcp), the world size, the rank and the backend are given, and a
    missing one raises. ``gloo`` is for the CPU and for ranks that share a
    card (card tensors go through the host, ``dist.comm``); ``nccl`` is for
    one card per rank: `device` (default ``cuda:<process_id mod cards>``)
    becomes this rank's current card, and ranks that name one card raise
    here, before NCCL opens a communicator. Every wait of the group fails
    after `timeout` seconds instead of hanging on a dead peer.
    """
    args = dict(coordinator=coordinator, num_processes=num_processes,
                process_id=process_id, backend=backend)
    missing = [k for k, v in args.items() if v is None]
    if missing:
        raise ValueError(f"init_multihost needs {', '.join(missing)}: there is no metadata "
                         f"server to detect them from")
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside [0, {num_processes})")
    if not timeout or timeout <= 0:
        raise ValueError(f"timeout must be positive seconds, got {timeout}")
    init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    limit = datetime.timedelta(seconds=timeout)
    if backend == "gloo":
        dist.init_process_group("gloo", init_method=init, world_size=num_processes,
                                rank=process_id, timeout=limit)
        return
    card = resolve(device if device is not None
                   else f"cuda:{process_id % max(torch.cuda.device_count(), 1)}")
    if card.type != "cuda":
        raise ValueError(f"nccl needs a card for each rank, got {card}")
    # gloo carries host objects (the card check, checkpoint plans); NCCL the
    # card tensors, and its communicator opens at the first card collective
    dist.init_process_group("cpu:gloo,cuda:nccl", init_method=init,
                            world_size=num_processes, rank=process_id, timeout=limit)
    cards = [None] * num_processes
    dist.all_gather_object(cards, str(torch.cuda.get_device_properties(card).uuid))
    if len(set(cards)) < num_processes:
        dist.destroy_process_group()
        raise ValueError(f"nccl needs one card per rank; ranks share cards {cards} (use gloo "
                         f"for ranks on one card)")
    torch.cuda.set_device(card)


def layout(time: int, channel: int, rank_devices, rank: int, hosts=None) -> Mesh:
    """The [time, channel] mesh over every rank's local devices in rank
    order (`rank_devices[r]`: rank r's devices), as this `rank` sees it;
    `hosts[r]` is rank r's host name (default: every rank on this host)."""
    if hosts is None:
        hosts = [socket.gethostname()] * len(rank_devices)
    if len(hosts) != len(rank_devices):
        raise ValueError(f"{len(hosts)} host names for {len(rank_devices)} ranks")
    flat = [(torch.device(d), r) for r, devs in enumerate(rank_devices) for d in devs]
    n = time * channel
    if n > len(flat):
        raise ValueError(f"need {n} devices, have {len(flat)}")
    flat = flat[:n]
    grid = [flat[p * channel:(p + 1) * channel] for p in range(time)]
    return Mesh(tuple(tuple(d for d, _ in row) for row in grid),
                tuple(tuple(r for _, r in row) for row in grid), rank, tuple(hosts))


def _enable_peers(devices) -> None:
    cards = sorted({d.index for d in devices if d.type == "cuda"})
    if len(cards) < 2:
        return
    from srcdsp_tpu_torch.kernels import _build

    lib = _build.load()
    for a in cards:
        for b in cards:
            if a != b and lib.srcdsp_enable_peer(a, b) != 0:
                raise RuntimeError(f"cuda:{a} has no peer access to cuda:{b}; the mesh "
                                   f"needs it for the halo kernels")


def make_mesh(time: int = 1, channel: int = 1, devices=None) -> Mesh:
    """Mesh of shape [time, channel] over the first time*channel `devices`
    (default: the CUDA devices, cuda:0 first). A given list may repeat a
    device: ``["cpu"] * 4`` or ``[torch.device("cuda:0")] * 4``.

    After `init_multihost`, `devices` are this rank's local devices and every
    rank calls `make_mesh` (a collective): the grid is laid over all ranks'
    devices in rank order (`layout`)."""
    if devices is None:
        resolve(None)
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [resolve(d) for d in devices]
    from srcdsp_tpu_torch.dist import comm

    if comm.world() > 1:
        got = [None] * comm.world()
        dist.all_gather_object(got, (socket.gethostname(), [str(d) for d in devs]))
        names = [n for _, n in got]
        names[comm.rank()] = devs
        mesh = layout(time, channel, names, comm.rank(), [h for h, _ in got])
        _enable_peers([d for drow, rrow in zip(mesh.devices, mesh.ranks)
                       for d, r in zip(drow, rrow) if r == mesh.rank])
        return mesh
    n = time * channel
    if n > len(devs):
        raise ValueError(f"need {n} devices, have {len(devs)}")
    devs = devs[:n]
    _enable_peers(devs)
    return Mesh(tuple(tuple(devs[p * channel:(p + 1) * channel]) for p in range(time)))


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How a tensor is cut over a mesh axis: tensor dim `dim` in equal
    blocks along mesh axis `axis`, block i held by rank ``owners[i]`` on
    ``devices[i]``; `indices` are the global blocks this rank holds, in
    order (all of them in one process). It places a tensor with no mesh at
    hand, as the reference's ``NamedSharding`` does (``io.capture.
    device_blocks``)."""

    axis: str
    dim: int
    owners: tuple[int, ...]
    indices: tuple[int, ...]
    devices: tuple[torch.device, ...]

    @property
    def num_shards(self) -> int:
        return len(self.owners)

    @property
    def local_devices(self) -> tuple[torch.device, ...]:
        """The devices of this rank's blocks, in `indices` order."""
        return tuple(self.devices[i] for i in self.indices)


def sharding(mesh: Mesh, axis: str, dim: int) -> Sharding:
    """Tensor dim `dim` (>= 0) cut over mesh axis `axis`."""
    return Sharding(axis, dim, mesh.axis_ranks(axis), mesh.local_indices(axis),
                    mesh.axis_devices(axis))


def time_sharding(mesh: Mesh, ndim: int = 1) -> Sharding:
    """Shard the last axis (time) across the 'time' mesh axis."""
    return sharding(mesh, TIME_AXIS, ndim - 1)


def channel_sharding(mesh: Mesh, ndim: int = 2, axis: int = 0) -> Sharding:
    """Shard a channel axis across the 'channel' mesh axis."""
    return sharding(mesh, CHANNEL_AXIS, axis % ndim)


def copy_to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A copy of t on `device`, a buffer of its own even on t's device."""
    out = torch.empty(t.shape, dtype=t.dtype, device=device)
    out.copy_(t)
    return out


def shard(x: torch.Tensor, mesh: Mesh, axis: str = TIME_AXIS, dim: int = -1
          ) -> tuple[torch.Tensor, ...]:
    """Split x along `dim` into equal contiguous blocks, one per shard of
    `axis`, and copy the blocks this process holds to their devices
    (``device_put`` with `time_sharding` / `channel_sharding`)."""
    n = mesh.shape[axis]
    if x.shape[dim] % n != 0:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {n} shards")
    parts = x.chunk(n, dim=dim)
    devs = mesh.axis_devices(axis)
    return tuple(copy_to(parts[i], devs[i]) for i in mesh.local_indices(axis))


def local_shards(x_local: torch.Tensor, mesh: Mesh, spec: Sharding) -> tuple[torch.Tensor, ...]:
    """This rank's slice of a global array, the concatenation of the blocks
    it holds along ``spec.dim``, as its shards on their devices (the
    counterpart of ``multihost_utils.host_local_array_to_global_array``)."""
    k = len(spec.indices)
    if k == 0 or x_local.shape[spec.dim] % k != 0:
        raise ValueError(f"local slice {tuple(x_local.shape)} does not split into {k} shards "
                         f"along dim {spec.dim}")
    devs = mesh.axis_devices(spec.axis)
    return tuple(copy_to(part, devs[i])
                 for part, i in zip(x_local.chunk(k, dim=spec.dim), spec.indices))


def process_allgather(shards, spec: Sharding, tiled: bool = True) -> torch.Tensor:
    """Every shard of a sharded array, on every rank, on the device of this
    rank's first shard: concatenated along ``spec.dim`` in mesh order
    (tiled), else stacked on a new leading axis (the counterpart of
    ``multihost_utils.process_allgather``). Shards have equal shapes."""
    from srcdsp_tpu_torch.dist import comm

    if len(shards) != len(spec.indices) or not shards:
        raise ValueError(f"{len(shards)} shards for local indices {spec.indices}")
    device = shards[0].device
    owners = spec.owners
    if len(set(owners)) == 1:
        full = [s.to(device) for s in shards]
    else:
        width = max(owners.count(r) for r in set(owners))
        mine = list(shards) + [torch.zeros_like(shards[0])] * (width - len(shards))
        got = comm.all_gather(torch.stack([s.to(device) for s in mine]), device)
        seen = {r: 0 for r in set(owners)}
        full = []
        for r in owners:
            full.append(got[r][seen[r]])
            seen[r] += 1
    return torch.cat(full, dim=spec.dim) if tiled else torch.stack(full)


def unshard(shards, device, dim: int = -1) -> torch.Tensor:
    """The sharded array as one tensor on `device` (in one process)."""
    return torch.cat([s.to(device) for s in shards], dim=dim)


def device_guard(device: torch.device):
    """Make `device` current for the launches in a `with` block (a no-op on
    the CPU), so a kernel goes to its shard's card and current stream."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def per_device(make: Callable, devices) -> tuple:
    """make(device) for each of `devices`, called once per distinct device.
    A kernel or a parameter set is built for one device, so a sharded call
    takes one per shard: on a mesh of one repeated device they are one
    object, across cards one each."""
    built = {}
    for d in devices:
        if d not in built:
            built[d] = make(d)
    return tuple(built[d] for d in devices)


def map_shards(fn: Callable, mesh: Mesh, *args, axis: str = TIME_AXIS) -> tuple:
    """fn(*per-shard args) on every shard of `axis` this process holds, under
    its device: each arg is a sharded array (a tuple, one entry per local
    shard). No collective."""
    devs = mesh.local_devices(axis)
    for a in args:
        if len(a) != len(devs):
            raise ValueError(f"{len(a)} shards for {len(devs)} devices on {axis!r}")
    out = []
    for p, d in enumerate(devs):
        with device_guard(d):
            out.append(fn(*(a[p] for a in args)))
    return tuple(out)
