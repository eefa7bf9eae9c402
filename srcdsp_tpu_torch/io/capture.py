"""Binary IQ capture read/write (counterpart of ``srcdsp_tpu/io/capture.py``).

The reference reads/writes raw binary IQ sample files through fstream
classes (SURVEY.md §1.1 L4). Format here is the same wire format —
interleaved I,Q — in int16 ('ci16'), float32 ('cf32'), offset-binary
uint8 ('cu8', the rtl-sdr wire format: (b-127.5)/127.5), or signed int8
('ci8', HackRF-style: b/127), little-endian, with an optional JSON sidecar ('<file>.json') carrying sample rate, center
frequency, and scale; files without a sidecar default to ci16 full-scale.

Host side is numpy memmap (zero-copy view of the capture); `device_blocks`
hands fixed-size blocks to a torch device, or time-sharded over a mesh — the
streaming source for the block loops of the chains.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.types import DEFAULT_SCALE, np_complex64_to_int16, np_int16_to_complex64

FORMATS = ("ci16", "cf32", "cu8", "ci8")

# wire dtype and bytes per complex sample
_WIRE = {"ci16": (np.dtype("<i2"), 4), "cf32": (np.dtype("<f4"), 8),
         "cu8": (np.dtype("u1"), 2), "ci8": (np.dtype("i1"), 2)}

# host-to-device copies made by `device_blocks`, per target device (a
# placement on the CPU counts too): {device: {"copies", "bytes"}}
H2D: dict[str, dict[str, int]] = {}


def _decode(raw: np.ndarray, meta: "CaptureMeta") -> np.ndarray:
    """Interleaved wire samples -> complex64."""
    if meta.fmt == "ci16":
        return np_int16_to_complex64(np.asarray(raw), scale=meta.scale)
    raw = np.asarray(raw)
    if meta.fmt == "cf32":
        f = raw
    elif meta.fmt == "cu8":
        f = (raw.astype(np.float32) - np.float32(127.5)) / np.float32(127.5)
    else:                                            # ci8
        f = raw.astype(np.float32) / np.float32(127.0)
    return (f[0::2] + 1j * f[1::2]).astype(np.complex64)


def _encode(x: np.ndarray, meta: "CaptureMeta") -> np.ndarray:
    """complex64 -> interleaved wire samples (saturating for int formats)."""
    if meta.fmt == "ci16":
        return np_complex64_to_int16(x, scale=meta.scale)
    f = interleave_cf32(x)
    if meta.fmt == "cf32":
        return f
    if meta.fmt == "cu8":
        return np.clip(np.round(f * 127.5 + 127.5), 0, 255).astype(np.uint8)
    return np.clip(np.round(f * 127.0), -128, 127).astype(np.int8)  # ci8


@dataclasses.dataclass
class CaptureMeta:
    fmt: str = "ci16"
    sample_rate: float = 1.0
    center_freq: float = 0.0
    scale: float = DEFAULT_SCALE
    num_samples: int = 0

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "CaptureMeta":
        return cls(**json.loads(s))


def interleave_cf32(x: np.ndarray) -> np.ndarray:
    """complex64 -> interleaved I,Q float32 wire samples (the cf32 body;
    shared by write_capture and the CLI tools)."""
    x = np.asarray(x).reshape(-1)
    raw = np.empty(2 * x.shape[0], np.float32)
    raw[0::2] = x.real
    raw[1::2] = x.imag
    return raw


def _sidecar(path: str) -> str:
    return path + ".json"


def write_capture(path: str, x: np.ndarray, meta: CaptureMeta | None = None) -> CaptureMeta:
    """Write complex64 samples as interleaved IQ; returns the final metadata."""
    meta = meta or CaptureMeta()
    if meta.fmt not in FORMATS:
        raise ValueError(f"unknown format {meta.fmt!r}")
    x = np.asarray(x, np.complex64).reshape(-1)
    meta.num_samples = x.shape[0]
    raw = _encode(x, meta)
    raw.astype(raw.dtype.newbyteorder("<")).tofile(path)
    with open(_sidecar(path), "w") as f:
        f.write(meta.to_json())
    return meta


def read_meta(path: str) -> CaptureMeta:
    if os.path.exists(_sidecar(path)):
        with open(_sidecar(path)) as f:
            return CaptureMeta.from_json(f.read())
    n_bytes = os.path.getsize(path)
    return CaptureMeta(fmt="ci16", num_samples=n_bytes // 4)


def read_capture(path: str, mmap: bool = True) -> tuple[np.ndarray, CaptureMeta]:
    """Read a capture to complex64. With mmap=True the raw file is memmapped
    (the int16->float conversion still materializes)."""
    meta = read_meta(path)
    dtype = _WIRE[meta.fmt][0]
    raw = (np.memmap(path, dtype, mode="r") if mmap
           else np.fromfile(path, dtype))
    return _decode(raw, meta), meta


def read_capture_blocks(path: str, block: int, start_block: int = 0):
    """Generator of complex64 blocks of `block` samples (memmap-backed).

    `start_block` supports checkpoint/resume: seek straight to a block
    offset. The trailing partial block (if any) is dropped — streaming
    chains require full blocks.
    """
    meta = read_meta(path)
    raw = np.memmap(path, _WIRE[meta.fmt][0], mode="r")
    per_block = 2 * block
    nb = raw.shape[0] // per_block
    for b in range(start_block, nb):
        yield _decode(raw[b * per_block:(b + 1) * per_block], meta)


def _placed(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """arr on `device`: one host-to-device copy, counted in `H2D`."""
    t = torch.from_numpy(arr).to(device)
    c = H2D.setdefault(str(device), {"copies": 0, "bytes": 0})
    c["copies"] += 1
    c["bytes"] += arr.nbytes
    return t


def reset_h2d() -> None:
    """Zero the `H2D` counts."""
    H2D.clear()


def _block_array(xb: np.ndarray, planes: bool) -> np.ndarray:
    return np.stack([xb.real, xb.imag]).astype(np.float32) if planes else xb


def _shard_plan(sharding, block: int, planes: bool) -> tuple[int, tuple]:
    """(samples a shard, this process's resolved devices) of a time sharding
    of the capture's blocks; raises for what it cannot place."""
    from srcdsp_tpu_torch.dist.mesh import TIME_AXIS

    ndim, what = (2, "[2, block] planes") if planes else (1, "[block] samples")
    if sharding.axis != TIME_AXIS or sharding.dim != ndim - 1:
        raise ValueError(f"a capture is one channel: its {what} shard only along time (dim "
                         f"{ndim - 1} over {TIME_AXIS!r}), got dim {sharding.dim} over "
                         f"{sharding.axis!r}")
    n = sharding.num_shards
    if block % n != 0:
        raise ValueError(f"block {block} does not split over {n} shards")
    return block // n, tuple(resolve(d) for d in sharding.local_devices)


def device_blocks(path: str, block: int, start_block: int = 0, device=None,
                  planes: bool = False, sharding=None):
    """Generator of fixed-size blocks as torch tensors on `device`.

    planes=True yields [2, block] float32 (real, imag) planes — the layout
    the kernels consume — instead of [block] complex64.

    With `sharding` (``dist.mesh.time_sharding(mesh, 2)`` for planes, ``1``
    for complex samples) each block lands time-sharded, as the reference's
    ``device_put`` with a ``NamedSharding`` lands it: the block is the tuple
    of this process's shards in mesh order (every shard in one process, the
    shards of ``sharding.indices`` on a mesh across processes), each decoded
    from its own slice of the memmap and copied from the host straight to
    its device. No block is assembled on one device, and no shard moves
    between devices. The shards equal ``dist.mesh.shard`` of the whole
    block. Each host-to-device copy is counted in `H2D`. Raises (at the
    call) for `device` and `sharding` together, for a sharding that does not
    cut the blocks' time dim, for a block that does not split evenly, and
    for a mesh on a card this machine lacks.
    """
    if sharding is None:
        device = resolve(device)
        return (_placed(_block_array(xb, planes), device)
                for xb in read_capture_blocks(path, block, start_block=start_block))
    if device is not None:
        raise ValueError("pass device or sharding, not both: a sharding names its devices")
    per, devs = _shard_plan(sharding, block, planes)
    return _sharded_blocks(path, block, start_block, planes, per,
                           tuple(zip(sharding.indices, devs)))


def _sharded_blocks(path: str, block: int, start_block: int, planes: bool, per: int,
                    targets: tuple):
    meta = read_meta(path)
    raw = np.memmap(path, _WIRE[meta.fmt][0], mode="r")
    for b in range(start_block, raw.shape[0] // (2 * block)):
        shards = []
        for q, d in targets:
            s0 = b * block + q * per
            xb = _decode(raw[2 * s0:2 * (s0 + per)], meta)
            shards.append(_placed(_block_array(xb, planes), d))
        yield tuple(shards)
