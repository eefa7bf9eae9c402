"""Device meshes and sharded arrays (counterpart of ``srcdsp_tpu/dist/mesh.py``).

Axis names are fixed: ``time`` for time-block (sequence) parallelism,
``channel`` for channel (data) parallelism. A mesh is a [time, channel] grid
of ``torch.device``s in one process. A device may repeat, so P shards can sit
on one card (or on the CPU) as P virtual devices, as the reference's tests
run on 8 virtual CPU devices: the halo still moves between shard buffers, and
only a transfer's time needs two cards. Where a mesh holds two cards, each
pair gets peer access (``csrc/halo.cu``), so a kernel on one card reads the
other's memory; a pair without it raises.

The port has no global sharded array: a sharded array is a tuple of
per-shard tensors in mesh order, each on its shard's device (`shard`,
`unshard`). `map_shards` runs a body with no collective on every shard, the
``shard_map`` counterpart for such bodies. Multi-process bring-up
(``init_multihost``) is not ported.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, ClassVar

import torch

from srcdsp_tpu_torch.device import resolve

TIME_AXIS = "time"
CHANNEL_AXIS = "channel"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """devices[p][q]: the shard at time index p and channel index q."""

    devices: tuple[tuple[torch.device, ...], ...]
    axis_names: ClassVar[tuple[str, str]] = (TIME_AXIS, CHANNEL_AXIS)

    @property
    def shape(self) -> dict[str, int]:
        return {TIME_AXIS: len(self.devices), CHANNEL_AXIS: len(self.devices[0])}

    def axis_devices(self, axis: str = TIME_AXIS) -> tuple[torch.device, ...]:
        """The devices along `axis` (at index 0 of the other axis)."""
        if axis == TIME_AXIS:
            return tuple(row[0] for row in self.devices)
        if axis == CHANNEL_AXIS:
            return self.devices[0]
        raise ValueError(f"axis {axis!r} not in {self.axis_names}")


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
    device: ``["cpu"] * 4`` or ``[torch.device("cuda:0")] * 4``."""
    if devices is None:
        resolve(None)
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [resolve(d) for d in devices]
    n = time * channel
    if n > len(devs):
        raise ValueError(f"need {n} devices, have {len(devs)}")
    devs = devs[:n]
    _enable_peers(devs)
    return Mesh(tuple(tuple(devs[p * channel:(p + 1) * channel]) for p in range(time)))


def copy_to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A copy of t on `device`, a buffer of its own even on t's device."""
    out = torch.empty(t.shape, dtype=t.dtype, device=device)
    out.copy_(t)
    return out


def shard(x: torch.Tensor, mesh: Mesh, axis: str = TIME_AXIS, dim: int = -1
          ) -> tuple[torch.Tensor, ...]:
    """Split x along `dim` into equal contiguous blocks, one per shard of
    `axis`, each copied to its shard's device (`time_sharding` /
    `channel_sharding` of the reference)."""
    devs = mesh.axis_devices(axis)
    if x.shape[dim] % len(devs) != 0:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {len(devs)} "
                         f"shards")
    return tuple(copy_to(part, d) for part, d in zip(x.chunk(len(devs), dim=dim), devs))


def unshard(shards, device, dim: int = -1) -> torch.Tensor:
    """The sharded array as one tensor on `device`."""
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
    """fn(*per-shard args) on every shard of `axis`, under its device: each
    arg is a sharded array (a tuple, one entry per shard). No collective."""
    devs = mesh.axis_devices(axis)
    for a in args:
        if len(a) != len(devs):
            raise ValueError(f"{len(a)} shards for {len(devs)} devices on {axis!r}")
    out = []
    for p, d in enumerate(devs):
        with device_guard(d):
            out.append(fn(*(a[p] for a in args)))
    return tuple(out)
