"""The repository's C++ libraries (``cpp/<dir>/``) as the port builds and
binds them.

A library is built at first use by its own Makefile, with g++, into
``build/srcdsp_tpu_torch/<name>/<hash of the source and Makefile>/`` at the
root of the checkout (``make -C cpp/<dir> BUILD=<that directory>``), through a
temporary directory and an atomic rename, so that concurrent test workers can
build it at once and the checkout's source is what runs. The tracked
``cpp/<dir>/build/`` is never written. A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


class MakeLibrary:
    """``cpp/<cpp_dir>/<source>`` built into ``lib<name>.so``, its entry points
    given `signatures` (name -> argtypes) and one `restype`."""

    def __init__(self, cpp_dir: str, source: str, name: str, signatures: dict, restype):
        self.src_dir = ROOT / "cpp" / cpp_dir
        self.source = source
        self.build_root = ROOT / "build" / "srcdsp_tpu_torch" / name
        self.so_name = f"lib{name}.so"
        self.signatures = signatures
        self.restype = restype
        self._lib = None

    def path(self) -> Path:
        h = hashlib.sha256()
        for f in (self.source, "Makefile"):
            h.update((self.src_dir / f).read_bytes())
        return self.build_root / h.hexdigest()[:16] / self.so_name

    def build(self) -> Path:
        """Build the library unless this exact build exists; return the .so path."""
        lib = self.path()
        if lib.exists():
            return lib
        lib.parent.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=lib.parent) as tmp:
            proc = subprocess.run(["make", "-C", str(self.src_dir), f"BUILD={tmp}"],
                                  capture_output=True, text=True)
            built = Path(tmp) / self.so_name
            if proc.returncode != 0 or not built.exists():
                raise RuntimeError(f"{self.so_name} build failed ({proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(built, lib)  # atomic: a concurrent build finds a whole library
        return lib

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            for name, argtypes in self.signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = self.restype
            self._lib = lib
        return self._lib
