"""Port vs JAX package: int16 <-> complex conversions, u32 NCO words, window taps.

All contracts here are bit-exact: the same numpy inputs go to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu import types as jtypes
from srcdsp_tpu.ops import nco as jnco
from srcdsp_tpu.ops import window as jwindow
from srcdsp_tpu_torch import types as ttypes
from srcdsp_tpu_torch.ops import nco as tnco
from srcdsp_tpu_torch.ops import window as twindow
from tests.torch_threads import one_torch_thread  # noqa: F401


def test_int16_to_complex64_bit_exact():
    iq = np.random.default_rng(0).integers(-32768, 32768, size=(3, 2 * 257), dtype=np.int16)
    iq[0, :4] = [-32768, 32767, 0, -1]
    ref = np.asarray(jtypes.int16_to_complex64(jnp.asarray(iq)))
    got = ttypes.int16_to_complex64(torch.as_tensor(iq)).numpy()
    assert got.dtype == np.complex64
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
    np.testing.assert_array_equal(ttypes.np_int16_to_complex64(iq), ref)


@pytest.mark.parametrize("interleave", [True, False])
def test_complex64_to_int16_bit_exact(interleave):
    rng = np.random.default_rng(1)
    x = (rng.uniform(-1.2, 1.2, 512) + 1j * rng.uniform(-1.2, 1.2, 512)).astype(np.complex64)
    # exact half-LSB ties (round half to even) and saturation
    x[:4] = np.array([0.5, 1.5, 2.5, -2.5], np.float32) / np.float32(32767.0) + 0j
    x[4:6] = [2.0 + 2.0j, -2.0 - 2.0j]
    ref = np.asarray(jtypes.complex64_to_int16(jnp.asarray(x), interleave=interleave))
    got = ttypes.complex64_to_int16(torch.as_tensor(x), interleave=interleave).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(ttypes.np_complex64_to_int16(x, interleave=interleave), ref)


def test_freq_to_word_bit_exact():
    f = np.concatenate([np.linspace(-1.5, 1.5, 1001), [0.0, 0.5, -0.5, 1e-10, 0.11, -0.11]])
    np.testing.assert_array_equal(tnco.freq_to_word(f), jnco.freq_to_word(f))


@pytest.mark.parametrize("split", [1, 7, 4096])
def test_nco_phase_words_bit_exact_across_splits(split):
    """Phase words after every block equal the JAX package's, for blocks of
    1, 7 and 4096 samples, on two channels with different words."""
    words = np.asarray([jnco.freq_to_word(0.1234567), jnco.freq_to_word(-0.377)], np.uint32)
    n_blocks = 40 if split < 4096 else 3
    rng = np.random.default_rng(split)
    x = (rng.standard_normal((2, split * n_blocks))
         + 1j * rng.standard_normal((2, split * n_blocks))).astype(np.complex64)
    js = jnco.nco_init((2,), phase0=0.3)
    ts = tnco.nco_init((2,), phase0=0.3, device="cpu")
    np.testing.assert_array_equal(ts.phase.numpy(), np.asarray(js.phase).astype(np.int64))
    for b in range(n_blocks):
        xb = x[:, b * split:(b + 1) * split]
        js, jy = jnco.nco_apply(jnp.asarray(words), js, jnp.asarray(xb))
        ts, ty = tnco.nco_apply(words, ts, torch.as_tensor(xb))
        np.testing.assert_array_equal(ts.phase.numpy(), np.asarray(js.phase).astype(np.int64))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=2e-6)


@pytest.mark.parametrize("num_taps,cutoff,window", [
    (64, 0.03, "hamming"), (64, 0.2, "hamming"), (33, 0.1, "kaiser"), (17, 0.3, "rect")])
def test_window_lowpass_bit_equal(num_taps, cutoff, window):
    np.testing.assert_array_equal(twindow.lowpass(num_taps, cutoff, window=window),
                                  jwindow.lowpass(num_taps, cutoff, window=window))


@pytest.mark.parametrize("sps,span,beta", [(4, 4, 0.35), (8, 8, 0.35), (4, 8, 0.25), (2, 6, 0.0)])
def test_window_root_raised_cosine_bit_equal(sps, span, beta):
    np.testing.assert_array_equal(twindow.root_raised_cosine(sps, span, beta),
                                  jwindow.root_raised_cosine(sps, span, beta))


def test_window_primitives_bit_equal():
    np.testing.assert_array_equal(twindow.hamming(65), jwindow.hamming(65))
    np.testing.assert_array_equal(twindow.kaiser(65, 5.65), jwindow.kaiser(65, 5.65))
