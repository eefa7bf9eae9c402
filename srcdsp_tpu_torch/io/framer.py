"""ctypes binding of the native ingest framer ``cpp/ingest/framer.cc``
(counterpart of ``srcdsp_tpu/io/framer.py``): one C++ pass converts a capture
and emits the [NT, span] frame planes the pre-framed kernels consume (K5, K7).

The library is built at first use by the repository's own Makefile, with g++,
into ``build/srcdsp_tpu_torch/framer/<hash of the source and Makefile>/`` at
the root of the checkout (``make -C cpp/ingest BUILD=<that directory>``), so
the checkout's source is what runs. A failed build raises.

Contracts, as the JAX binding's: frames equal `frame_planes` of the converted
stream bit for bit; int16 converts as x / scale; bf16 is round-to-nearest-even
of that f32 value, the same bits as ``tensor.to(torch.bfloat16)``. Outputs are
CPU tensors (bf16 as ``torch.bfloat16``); `frame_ci16`, the serving producer,
can write them into pinned memory for an asynchronous copy to the card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
SRC_DIR = ROOT / "cpp" / "ingest"
BUILD_ROOT = ROOT / "build" / "srcdsp_tpu_torch" / "framer"

_P, _L, _F, _I = ctypes.c_void_p, ctypes.c_long, ctypes.c_float, ctypes.c_int
_SIGNATURES = {
    "ing_frame_ci16_f32_mt": [_P, _L, _L, _L, _L, _F, _P, _P, _I],
    "ing_frame_ci16_bf16_mt": [_P, _L, _L, _L, _L, _F, _P, _P, _I],
    "ing_frame_f32": [_P, _P, _L, _L, _L, _L, _P, _P],
    "ing_frame_cu8_f32_mt": [_P, _L, _L, _L, _L, _P, _P, _I],
    "ing_frame_ci8_f32_mt": [_P, _L, _L, _L, _L, _P, _P, _I],
}


def library_path() -> Path:
    h = hashlib.sha256()
    for name in ("framer.cc", "Makefile"):
        h.update((SRC_DIR / name).read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libframer.so"


def build() -> Path:
    """Build the framer unless this exact build exists; return the .so path."""
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=lib.parent) as tmp:
        proc = subprocess.run(["make", "-C", str(SRC_DIR), f"BUILD={tmp}"],
                              capture_output=True, text=True)
        built = Path(tmp) / lib.name
        if proc.returncode != 0 or not built.exists():
            raise RuntimeError(f"framer build failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(built, lib)  # atomic: a concurrent build finds a whole library
    return lib


@functools.cache
def load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_long
    return lib


def _outputs(nt: int, span: int, dtype: torch.dtype, pin_memory: bool = False):
    return tuple(torch.empty((max(nt, 0), span), dtype=dtype, pin_memory=pin_memory)
                 for _ in range(2))


def _check(nt: int, what: str) -> None:
    if nt < 0:
        raise ValueError(f"bad framer geometry for {what} (need span-stride=hist, "
                         f"hist | stride, N % stride)")


def frame_ci16(iq: np.ndarray, hist: int, stride: int, span: int, scale: float = 32767.0,
               bf16: bool = False, threads: int = 1, pin_memory: bool = False
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Interleaved int16 IQ [2*(hist+N)] (or [hist+N, 2]) -> frame planes
    (xr_f, xi_f) [NT, span], float32, or bfloat16 when `bf16`."""
    iq = np.ascontiguousarray(iq, np.int16).reshape(-1)
    n_total = iq.size // 2
    out_r, out_i = _outputs((n_total - hist) // stride, span,
                            torch.bfloat16 if bf16 else torch.float32, pin_memory)
    sym = "ing_frame_ci16_bf16_mt" if bf16 else "ing_frame_ci16_f32_mt"
    nt = getattr(load(), sym)(iq.ctypes.data, n_total, hist, stride, span, scale,
                              out_r.data_ptr(), out_i.data_ptr(), threads)
    _check(nt, "frame_ci16")
    return out_r, out_i


def frame_f32(planes: np.ndarray, hist: int, stride: int, span: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 planes [2, hist+N] -> frame planes (xr_f, xi_f) [NT, span] f32."""
    planes = np.ascontiguousarray(planes, np.float32)
    n_total = planes.shape[-1]
    out_r, out_i = _outputs((n_total - hist) // stride, span, torch.float32)
    nt = load().ing_frame_f32(planes[0].ctypes.data, planes[1].ctypes.data, n_total, hist,
                              stride, span, out_r.data_ptr(), out_i.data_ptr())
    _check(nt, "frame_f32")
    return out_r, out_i


def _frame_bytes(iq: np.ndarray, hist: int, stride: int, span: int, threads: int,
                 sym: str) -> tuple[torch.Tensor, torch.Tensor]:
    n_total = iq.size // 2
    out_r, out_i = _outputs((n_total - hist) // stride, span, torch.float32)
    nt = getattr(load(), sym)(iq.ctypes.data, n_total, hist, stride, span,
                              out_r.data_ptr(), out_i.data_ptr(), threads)
    _check(nt, sym)
    return out_r, out_i


def frame_cu8(iq: np.ndarray, hist: int, stride: int, span: int, threads: int = 1
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """rtl-sdr cu8 interleaved bytes [2*(hist+N)] -> f32 frame planes,
    (b - 127.5) / 127.5 as ``io/capture.py`` converts them."""
    iq = np.ascontiguousarray(iq, np.uint8).reshape(-1)
    return _frame_bytes(iq, hist, stride, span, threads, "ing_frame_cu8_f32_mt")


def frame_ci8(iq: np.ndarray, hist: int, stride: int, span: int, threads: int = 1
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """HackRF ci8 interleaved bytes -> f32 frame planes (b / 127)."""
    iq = np.ascontiguousarray(iq, np.int8).reshape(-1)
    return _frame_bytes(iq, hist, stride, span, threads, "ing_frame_ci8_f32_mt")
