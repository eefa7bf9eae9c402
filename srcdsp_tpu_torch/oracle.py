"""ctypes binding of the C++ golden oracle ``cpp/oracle/oracle.cc``: the
port's own copy of the functions of ``srcdsp_tpu/oracle.py`` that config 2
needs (`nco_mix`, `fir` with real taps, `resample`, `resample_stream`), with
the same arguments and results.

The library is built at first use by the repository's own Makefile into
``build/srcdsp_tpu_torch/oracle/<hash of oracle.cc and the Makefile>/``
(``_native.MakeLibrary``: a temporary directory and an atomic rename, so that
concurrent test workers can build it at once); it never writes
``cpp/oracle/build/``. A failed build raises.

Complex buffers are numpy complex64, passed as interleaved float32 views.
"""

from __future__ import annotations

import ctypes

import numpy as np

from srcdsp_tpu_torch._native import MakeLibrary

_P, _L, _I, _U = ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_uint32
_SIGNATURES = {
    "orc_fir": [_P, _L, _P, _L, _I, _P],
    "orc_nco_mix": [_P, _L, _U, _U, _P, _P],
    "orc_resample": [_P, _L, _P, _L, _I, _I, _P],
    "orc_resample_stream": [_P, _L, _P, _L, _I, _I, _P, _P, _P],
}


_LIB = MakeLibrary("oracle", "oracle.cc", "oracle", _SIGNATURES, None)
BUILD_ROOT = _LIB.build_root
library_path, build, load = _LIB.path, _LIB.build, _LIB.load


def _cf(x) -> np.ndarray:
    return np.ascontiguousarray(x, np.complex64)


def fir(x: np.ndarray, taps: np.ndarray, decim: int = 1) -> np.ndarray:
    """Causal FIR from rest with real taps, keeping every decim-th output:
    [N] -> [N/decim]."""
    x = _cf(x)
    taps = np.ascontiguousarray(taps, np.float32)
    out = np.empty(x.size // decim, np.complex64)
    load().orc_fir(x.ctypes.data, x.size, taps.ctypes.data, taps.size, decim, out.ctypes.data)
    return out


def nco_mix(x: np.ndarray, word0: int, dword: int) -> tuple[np.ndarray, int]:
    """x * e^{j 2 pi (word0 + k*dword) / 2^32}; returns (mixed, the next word)."""
    x = _cf(x)
    out = np.empty(x.size, np.complex64)
    end = ctypes.c_uint32(0)
    load().orc_nco_mix(x.ctypes.data, x.size, word0 % (1 << 32), dword % (1 << 32),
                       out.ctypes.data, ctypes.addressof(end))
    return out, int(end.value)


def resample(x: np.ndarray, taps: np.ndarray, up: int, down: int) -> np.ndarray:
    """Rational L/M resample from rest: y[j] = sum_k h[k] u[j*down - k]."""
    x = _cf(x)
    taps = np.ascontiguousarray(taps, np.float32)
    out = np.empty((x.size * up) // down, np.complex64)
    load().orc_resample(x.ctypes.data, x.size, taps.ctypes.data, taps.size, up, down,
                        out.ctypes.data)
    return out


def resample_stream(x: np.ndarray, taps: np.ndarray, up: int, down: int, hist: np.ndarray,
                    offset: int) -> tuple[np.ndarray, np.ndarray, int]:
    """Streaming rational resampler with a carried input tail and output phase.

    hist: [ceil((T-1)/up)] complex64 (zeros at start); offset: input samples
    consumed so far (0 at start). Returns (y, new_hist, new_offset); outputs
    concatenated over blocks equal one `resample` call.
    """
    x = _cf(x)
    taps = np.ascontiguousarray(taps, np.float32)
    h = (taps.size - 1 + up - 1) // up
    hist = _cf(hist).copy()
    if hist.size != h:
        raise ValueError(f"hist holds {hist.size} samples, expected {h}")
    j0 = (offset * up) // down
    jend = ((offset + x.size) * up) // down
    out = np.empty(jend - j0, np.complex64)
    off = ctypes.c_long(offset)
    load().orc_resample_stream(x.ctypes.data, x.size, taps.ctypes.data, taps.size, up, down,
                               hist.ctypes.data, ctypes.addressof(off), out.ctypes.data)
    return out, hist, int(off.value)
