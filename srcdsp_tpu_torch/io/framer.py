"""ctypes binding of the native ingest framer ``cpp/ingest/framer.cc``
(counterpart of ``srcdsp_tpu/io/framer.py``): one C++ pass converts a capture
and emits the [NT, span] frame planes the pre-framed kernels consume (K5, K7).

The library is built at first use by the repository's own Makefile into
``build/srcdsp_tpu_torch/framer/<hash>/`` (``_native.MakeLibrary``), so the
checkout's source is what runs. A failed build raises.

Contracts, as the JAX binding's: frames equal `frame_planes` of the converted
stream bit for bit; int16 converts as x / scale; bf16 is round-to-nearest-even
of that f32 value, the same bits as ``tensor.to(torch.bfloat16)``. Outputs are
CPU tensors (bf16 as ``torch.bfloat16``); `frame_ci16`, the serving producer,
can write them into pinned memory for an asynchronous copy to the card.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from srcdsp_tpu_torch._native import MakeLibrary

_P, _L, _F, _I = ctypes.c_void_p, ctypes.c_long, ctypes.c_float, ctypes.c_int
_SIGNATURES = {
    "ing_frame_ci16_f32_mt": [_P, _L, _L, _L, _L, _F, _P, _P, _I],
    "ing_frame_ci16_bf16_mt": [_P, _L, _L, _L, _L, _F, _P, _P, _I],
    "ing_frame_f32": [_P, _P, _L, _L, _L, _L, _P, _P],
    "ing_frame_cu8_f32_mt": [_P, _L, _L, _L, _L, _P, _P, _I],
    "ing_frame_ci8_f32_mt": [_P, _L, _L, _L, _L, _P, _P, _I],
}


_LIB = MakeLibrary("ingest", "framer.cc", "framer", _SIGNATURES, ctypes.c_long)
BUILD_ROOT = _LIB.build_root
library_path, build, load = _LIB.path, _LIB.build, _LIB.load


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
