"""Port vs JAX package: ``ops.fir.complex_conv`` with ``lhs_dilation`` and
``padding``, and ``testing.signals.tone`` with ``channel_shape``.

Contracts: `complex_conv` against the JAX one within atol 1e-5 (one conv1d
against XLA's dilated convolution, float32 sums in another order; the
strided form's contract in ``tests/test_torch_resample.py``), output shapes
equal, for zero-stuffing by 3 with uneven, negative (cropping) and
wider-than-the-taps padding, real and complex taps. `tone` against the
JAX one within atol 1e-4 at n = 1024 (the reference takes the phase in
float32, the port in float64: a float32 phase of f*k ~ 113 cycles is off by
up to ~8e-6 cycles, 5e-5 rad), every channel equal to the one-channel tone.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu.ops.fir import complex_conv as jax_complex_conv
from srcdsp_tpu.testing.signals import tone as jax_tone
from srcdsp_tpu_torch.ops.fir import complex_conv
from srcdsp_tpu_torch.testing.signals import tone
from tests.torch_threads import one_torch_thread  # noqa: F401


def _iq(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("padding", [(0, 2), (6, 1), (-2, 4), (9, 9)])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("complex_taps", [False, True])
def test_complex_conv_dilated_and_padded_matches_jax(padding, stride, complex_taps):
    rng = np.random.default_rng(17 * abs(padding[0]) + padding[1] + 5 * stride)
    x = _iq(rng, 2, 3, 41)
    h = _iq(rng, 7) if complex_taps else rng.standard_normal(7).astype(np.float32)
    kw = dict(stride=stride, lhs_dilation=3, padding=(padding,))
    want = np.asarray(jax_complex_conv(jnp.asarray(x), jnp.asarray(h), **kw))
    got = complex_conv(torch.from_numpy(x), torch.from_numpy(h), **kw).numpy()
    assert got.shape == want.shape and got.dtype == np.complex64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_complex_conv_dilation_of_a_real_input_and_the_defaults():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 33)).astype(np.float32)
    h = rng.standard_normal(5).astype(np.float32)
    want = np.asarray(jax_complex_conv(jnp.asarray(x), jnp.asarray(h), lhs_dilation=2,
                                       padding=((0, 1),)))
    got = complex_conv(torch.from_numpy(x), torch.from_numpy(h), lhs_dilation=2,
                       padding=((0, 1),)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # lhs_dilation 1 and zero padding are the valid strided form, unchanged
    xc = torch.from_numpy(_iq(rng, 33))
    assert torch.equal(complex_conv(xc, h, stride=2),
                       complex_conv(xc, h, stride=2, lhs_dilation=1, padding=((0, 0),)))
    with pytest.raises(ValueError, match="lhs_dilation"):
        complex_conv(xc, h, lhs_dilation=0)


@pytest.mark.parametrize("channel_shape", [(2, 3), (), (4,)])
def test_tone_channel_shape_matches_jax(channel_shape):
    want = np.asarray(jax_tone(1024, 0.11, 0.25, 0.5, channel_shape=channel_shape))
    got = tone(1024, 0.11, 0.25, 0.5, channel_shape=channel_shape)
    assert got.shape == want.shape == (*channel_shape, 1024) and got.dtype == np.complex64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got, np.broadcast_to(tone(1024, 0.11, 0.25, 0.5), got.shape))
    assert got.flags.writeable
