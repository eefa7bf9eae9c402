"""Build and load the hand-written CUDA kernels (``srcdsp_tpu_torch/csrc``).

The sources are compiled at first use, one nvcc per source, all started
together, and linked into one shared library with a plain C interface, loaded
with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC -c
    nvcc -shared

No ``--use_fast_math``: it would swap sinf, cosf and atan2f for approximate
forms. The library lands in ``build/srcdsp_tpu_torch/<hash of sources and
flags>/libsrcdsp_kernels.so`` at the root of the checkout, so a changed source
builds anew and an unchanged one is reused.

Each kernel wrapper adds one to its entry of `LAUNCHES` when it launches its
kernel (and nowhere else), so a run can show which kernels its path used.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("mixfir.cu", "fsk.cu", "ctaps.cu", "frame.cu", "resample.cu")
HEADERS = ("fsk_common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "srcdsp_tpu_torch"
LIB_NAME = "libsrcdsp_kernels.so"

LAUNCHES = {"mixfir": 0, "mixfir_mc": 0, "fsk_fused": 0, "fsk_ctaps": 0,
            "fsk_ctaps_bf16": 0, "mixfir_ctaps": 0, "mixfir_ctaps_bf16": 0,
            "ctaps_preframed": 0, "ctaps_preframed_bf16": 0, "frame": 0,
            "fsk_preframed": 0, "fsk_preframed_bf16": 0, "mix_resample": 0,
            "mix_resample_mc": 0, "resample_preframed": 0, "resample_preframed_bf16": 0}

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
# C entry points (csrc/*.cu) and their argument types
_SIGNATURES = {
    "srcdsp_mixfir": [_P, _P, _P, _P, _I, _P, _P] + [_I] * 7 + [_P],
    "srcdsp_fsk_fused": [_P, _P, _P, _P, _P, _P] + [_I] * 9 + [_P],
    "srcdsp_fsk_ctaps": [_P, _P, _P, _P, _P, _P] + [_I] * 10 + [_P],
    "srcdsp_fsk_preframed": [_P] * 7 + [_I] * 10 + [_P],
    "srcdsp_mixfir_ctaps": [_P] * 5 + [_U, _U] + [_I] * 7 + [_P],
    "srcdsp_ctaps_preframed": [_P] * 6 + [_U, _U] + [_I] * 7 + [_P],
    "srcdsp_frame": [_P] * 3 + [_I] * 6 + [_P],
    "srcdsp_mix_resample": [_P] * 6 + [_I] * 8 + [_P],
    "srcdsp_resample_preframed": [_P] * 5 + [_U, _U] + [_I] * 8 + [_P],
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def source_paths() -> list[Path]:
    return [CSRC / f for f in SOURCES + HEADERS]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")  # the toolkit's default install
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in source_paths():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile the kernels unless this exact build exists; return the .so path.

    nvcc's report (registers, shared memory, spills per kernel) is kept
    beside the library as nvcc.log.
    """
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=lib.parent) as tmp:
        objs = [Path(tmp) / (Path(s).stem + ".o") for s in SOURCES]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(SOURCES, objs)]
        logs = [p.communicate()[0] for p in procs]
        (lib.parent / "nvcc.log").write_text("".join(logs))
        for s, p, log in zip(SOURCES, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {s} ({p.returncode}):\n{log}")
        so = Path(tmp) / LIB_NAME
        proc = subprocess.run([nvcc, "-shared", "-o", str(so), *map(str, objs)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(so, lib)  # atomic: a concurrent build finds a whole library
    return lib


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed, then load the library with typed entry points."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error (refused launch)."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {rc}")


def stream_handle(t) -> int:
    """The current CUDA stream of `t`'s device, as the C entry points take it."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
