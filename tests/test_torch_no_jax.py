"""The port stands alone: no module of srcdsp_tpu_torch (nor chip_smoke.py,
nor the port's scripts in bench_torch/) imports jax or the JAX package, and
every CUDA source the build names exists.

A static AST scan, not a runtime check: an interpreter may import jax at start.
"""

import ast
from pathlib import Path

import pytest

from srcdsp_tpu_torch.kernels import _build
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((ROOT / "srcdsp_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + sorted((ROOT / "bench_torch").glob("*.py")))
FORBIDDEN = ("jax", "jaxlib", "srcdsp_tpu")


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = [n for n in _imports(path) if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_build_sources_exist():
    paths = _build.source_paths()
    assert {p.suffix for p in paths} == {".cu", ".cuh"}
    for p in paths:
        assert p.is_file(), p
    on_disk = {p.name for p in (ROOT / "srcdsp_tpu_torch" / "csrc").iterdir()}
    assert on_disk == {p.name for p in paths}


def test_build_flags_are_sm90a_without_fast_math():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "fast-math" not in flags


def test_scan_covers_the_distribution_tier_and_halo_cu_is_built():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("__init__", "mesh", "halo", "fused", "channelize"):
        assert f"srcdsp_tpu_torch/dist/{mod}.py" in names
    assert {"srcdsp_tpu_torch/kernels/halo_dma.py", "srcdsp_tpu_torch/kernels/halo_fused.py"} <= names
    assert "halo.cu" in _build.SOURCES
    assert {"srcdsp_halo", "srcdsp_halo_fused", "srcdsp_enable_peer"} <= set(_build._SIGNATURES)
    assert {"halo_dma", "halo_fused"} <= set(_build.LAUNCHES)


def test_scan_covers_the_ipc_boundary_and_its_entry_points_are_registered():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert "srcdsp_tpu_torch/dist/ipc.py" in names
    assert {"srcdsp_ipc_alloc", "srcdsp_ipc_open", "srcdsp_ipc_close", "srcdsp_ipc_free",
            "srcdsp_error_name"} <= set(_build._SIGNATURES)
    halo_cu = (ROOT / "srcdsp_tpu_torch" / "csrc" / "halo.cu").read_text()
    for name in ("srcdsp_ipc_alloc", "srcdsp_ipc_open", "srcdsp_ipc_close", "srcdsp_ipc_free",
                 "srcdsp_error_name"):
        assert f'extern "C" int {name}(' in halo_cu


def test_scan_covers_the_fec_tier():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("gf2", "interleave", "hdlc", "golay", "fec", "rs", "bch", "polar", "metrics",
                "testing/channel"):
        assert f"srcdsp_tpu_torch/{mod}.py" in names
