"""Port vs JAX package: carried-tail FIR and the plane-form fused mix+FIR+decimate.

Float tier: the same numpy inputs go to both packages; the outputs agree to
float32 rounding (rel L2 < 1e-5; the sums run in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu.ops import fir as jfir
from srcdsp_tpu.ops import nco as jnco
from srcdsp_tpu.ops import planes as jplanes
from srcdsp_tpu.ops.window import lowpass
from srcdsp_tpu_torch.ops import fir as tfir
from srcdsp_tpu_torch.ops import planes as tplanes
from tests.torch_threads import one_torch_thread  # noqa: F401


def _rel(got, ref):
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _cx(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("decim", [1, 2, 4])
def test_fir_apply_carried_blocks_match_jax(decim):
    taps = lowpass(31, 0.2)
    rng = np.random.default_rng(decim)
    x = _cx(rng, (2, 3 * 256))
    js = jfir.fir_init(31, (2,))
    ts = tfir.fir_init(31, (2,), device="cpu")
    for b in range(3):
        xb = x[:, b * 256:(b + 1) * 256]
        js, jy = jfir.fir_apply(jnp.asarray(taps), js, jnp.asarray(xb), decim=decim)
        ts, ty = tfir.fir_apply(taps, ts, torch.as_tensor(xb), decim=decim)
        assert ty.shape == jy.shape
        assert _rel(ty.numpy(), np.asarray(jy)) < 1e-5
        np.testing.assert_array_equal(ts.tail.numpy(), np.asarray(js.tail))


def test_fir_complex_taps_match_jax():
    rng = np.random.default_rng(5)
    taps = _cx(rng, 16)
    x = _cx(rng, (3, 200))
    ref = np.asarray(jfir.fir_full(jnp.asarray(taps), jnp.asarray(x), decim=2))
    got = tfir.fir_full(torch.as_tensor(taps), torch.as_tensor(x), decim=2).numpy()
    assert _rel(got, ref) < 1e-5


@pytest.mark.parametrize("t,m", [(64, 2), (33, 4), (16, 1)])
def test_fused_mix_fir_decim_planes_match_jax(t, m):
    taps = lowpass(t, 0.4 / max(m, 2))
    coef = jplanes.phase_coef_matrix(taps, m)
    np.testing.assert_array_equal(tplanes.phase_coef_matrix(taps, m), coef)
    h = jplanes.plane_hist_len(t, m)
    assert tplanes.plane_hist_len(t, m) == h
    n = 1024
    rng = np.random.default_rng(t)
    xr = rng.standard_normal((1, h + n)).astype(np.float32)
    xi = rng.standard_normal((1, h + n)).astype(np.float32)
    word = int(jnco.freq_to_word(0.0931))
    word0 = (-h * word) % (1 << 32)
    jr, ji = jplanes.fused_mix_fir_decim_planes(
        jnp.asarray(coef), jnp.asarray(word0, jnp.uint32), jnp.asarray(word, jnp.uint32),
        jnp.asarray(xr), jnp.asarray(xi), m, row_offset=4096)
    tr, ti = tplanes.fused_mix_fir_decim_planes(
        coef, word0, word, torch.as_tensor(xr), torch.as_tensor(xi), m, row_offset=4096)
    ref = np.asarray(jr) + 1j * np.asarray(ji)
    got = tr.numpy() + 1j * ti.numpy()
    assert _rel(got, ref) < 1e-5


def test_nco_planes_match_jax():
    jc, js = jplanes.nco_planes(jnp.asarray(123456789, jnp.uint32),
                                jnp.asarray(987654321, jnp.uint32), 4096, 77)
    tc, ts = tplanes.nco_planes(123456789, 987654321, 4096, 77, device="cpu")
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-6)


def test_planes_from_int16_bit_exact():
    iq = np.random.default_rng(2).integers(-32768, 32768, size=(2, 512), dtype=np.int16)
    jr, ji = jplanes.planes_from_int16(jnp.asarray(iq))
    tr, ti = tplanes.planes_from_int16(torch.as_tensor(iq))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
