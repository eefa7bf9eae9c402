"""Port vs JAX package: the ingest framer binding (``io/framer.py``), both on
the same ``cpp/ingest/framer.cc``.

Bit-exact throughout: the port's frames against the JAX binding's on the same
bytes (ci16 to f32 and bf16, f32 planes, cu8, ci8), across thread counts, and
against `frame_planes` of the stream converted by the port's own tier; the
framer's bf16 is the round-to-nearest-even of x / 32767 that
``planes_from_int16(...).to(torch.bfloat16)`` gives.
"""

import numpy as np
import pytest
import torch

from srcdsp_tpu.io import framer as jfr
from srcdsp_tpu_torch.io import framer as tfr
from srcdsp_tpu_torch.kernels.mixfir_preframed import frame_planes
from srcdsp_tpu_torch.ops.planes import planes_from_int16
from tests.torch_threads import one_torch_thread  # noqa: F401

HIST, STRIDE = 128, 1024
SPAN = STRIDE + HIST


def _iq(kind, nt=7, seed=0):
    rng = np.random.default_rng(seed)
    shape = (HIST + nt * STRIDE, 2)
    if kind == "ci16":
        return rng.integers(-32768, 32768, shape).astype(np.int16)
    if kind == "cu8":
        return rng.integers(0, 256, shape).astype(np.uint8)
    return rng.integers(-128, 128, shape).astype(np.int8)


def _bits(t: torch.Tensor) -> np.ndarray:
    """A frame plane's bits as numpy (bf16 as its uint16 storage)."""
    return t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 \
        else t.numpy()


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("bf16", [False, True])
def test_ci16_matches_jax_binding(bf16, threads):
    iq = _iq("ci16", nt=16, seed=threads)
    got = tfr.frame_ci16(iq, HIST, STRIDE, SPAN, bf16=bf16, threads=threads)
    ref = jfr.frame_ci16(iq, HIST, STRIDE, SPAN, bf16=bf16, threads=threads)
    for g, r in zip(got, ref):
        assert g.dtype == (torch.bfloat16 if bf16 else torch.float32)
        np.testing.assert_array_equal(_bits(g), r)
    one = tfr.frame_ci16(iq, HIST, STRIDE, SPAN, bf16=bf16, threads=1)
    assert all(torch.equal(a, b) for a, b in zip(got, one))


@pytest.mark.parametrize("bf16", [False, True])
def test_ci16_frames_equal_port_conversion_and_frame_planes(bf16):
    """The ingest contract the smoke run relies on: framer bits == frames of
    planes_from_int16 (then .to(bfloat16)) of the same capture."""
    iq = _iq("ci16", seed=2)
    xr, xi = planes_from_int16(torch.from_numpy(iq.reshape(-1)))
    planes = torch.stack([xr, xi])
    if bf16:
        planes = planes.to(torch.bfloat16)
    ref = frame_planes(planes, STRIDE, SPAN)
    got = tfr.frame_ci16(iq, HIST, STRIDE, SPAN, bf16=bf16, threads=4)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_f32_planes_match_jax_binding():
    planes = (_iq("ci16", seed=1).astype(np.float32) / 32767.0).T.copy()
    got = tfr.frame_f32(planes, HIST, STRIDE, SPAN)
    ref = jfr.frame_f32(planes, HIST, STRIDE, SPAN)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), r)


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("kind", ["cu8", "ci8"])
def test_byte_formats_match_jax_binding(kind, threads):
    iq = _iq(kind, nt=5, seed=4)
    port_fn = tfr.frame_cu8 if kind == "cu8" else tfr.frame_ci8
    jax_fn = jfr.frame_cu8 if kind == "cu8" else jfr.frame_ci8
    got = port_fn(iq, HIST, STRIDE, SPAN, threads=threads)
    ref = jax_fn(iq, HIST, STRIDE, SPAN, threads=threads)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), r)


def test_bad_geometry_raises():
    iq = _iq("ci16")
    with pytest.raises(ValueError):
        tfr.frame_ci16(iq, HIST, STRIDE + 8, SPAN)      # span - stride != hist
    with pytest.raises(ValueError):
        tfr.frame_ci16(iq[:-2], HIST, STRIDE, SPAN)     # N % stride != 0
    with pytest.raises(ValueError):
        tfr.frame_f32(np.zeros((2, HIST + 1000), np.float32), HIST, STRIDE, SPAN)


def test_build_is_cached_by_source_hash():
    lib = tfr.build()
    assert lib == tfr.library_path() and lib.is_file()
    assert lib.parent.parent == tfr.BUILD_ROOT
