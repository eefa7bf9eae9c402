"""Port vs JAX package: link metrics (``metrics``), the channel models
(``testing/channel``) and ``testing.signals.complex_awgn``.

- `metrics` is the reference's numpy, copied: every function gives the same
  value on the same inputs;
- `multipath_apply` equals the reference's exactly on integer-valued taps
  and samples (every sum exact in float32, in any order), and within
  rel L2 1e-6 on random ones;
- the random models cannot match `jax.random` draw for draw, so they are
  held to their statistics: `complex_awgn` power, `add_noise_snr` measured
  SNR within 0.2 dB (tensor and numpy), Rayleigh taps and Jakes fading at
  unit mean power, phase-noise variance 2 pi linewidth n; and a seed gives
  the same draw twice.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu import metrics as jm
from srcdsp_tpu.testing import channel as jch
from srcdsp_tpu_torch import metrics as tm
from srcdsp_tpu_torch.testing import channel as tch
from srcdsp_tpu_torch.testing.signals import complex_awgn
from tests.torch_threads import one_torch_thread  # noqa: F401

RNG = np.random.default_rng


def _cx(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def test_metrics_equal():
    rng = RNG(0)
    ref = _cx(rng, 500)
    rx = ref + 0.1 * _cx(rng, 500)
    pts = np.exp(2j * np.pi * (np.arange(4) + 0.5) / 4)
    for name, args, kw in [
            ("evm_rms", (rx, ref), {}), ("evm_rms", (rx, ref), {"normalize": "peak"}),
            ("evm_db", (rx, ref), {}), ("mer_db", (rx, ref), {}), ("evm_blind", (rx, pts), {}),
            ("goertzel", (ref, 0.1), {}), ("tone_power_db", (ref, 0.13, 2.0), {}),
            ("delay_estimate", (np.roll(ref, 7), ref), {"max_lag": 20})]:
        assert getattr(tm, name)(*args, **kw) == getattr(jm, name)(*args, **kw), name
    tx = rng.integers(0, 2, 300)
    rxb = np.concatenate([rng.integers(0, 2, 5), tx])
    rxb[50] ^= 1
    assert tm.ber(tx, rxb) == jm.ber(tx, rxb) == (1 / 300, 5, 300)
    assert tm.ser(tx, rxb, 8) == jm.ser(tx, rxb, 8)
    for a, b in zip(tm.xcorr(ref[:64], ref[:50], 10), jm.xcorr(ref[:64], ref[:50], 10)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tm.align_sequences(tx, rxb), jm.align_sequences(tx, rxb)):
        np.testing.assert_array_equal(a, b)
    assert sorted(tm.__all__) == sorted(jm.__all__)


def test_multipath_apply_exact_on_integers_and_close_on_floats():
    rng = RNG(1)
    h = (rng.integers(-3, 4, 6) + 1j * rng.integers(-3, 4, 6)).astype(np.complex64)
    x = (rng.integers(-8, 9, (2, 300)) + 1j * rng.integers(-8, 9, (2, 300))).astype(np.complex64)
    want = np.asarray(jch.multipath_apply(jnp.asarray(h), jnp.asarray(x)))
    got = tch.multipath_apply(h, torch.as_tensor(x))
    assert got.dtype == torch.complex64
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tch.multipath_apply(h, x), want)
    h, x = _cx(rng, 9), _cx(rng, (3, 400))
    want = np.asarray(jch.multipath_apply(jnp.asarray(h), jnp.asarray(x)))
    got = tch.multipath_apply(h, torch.as_tensor(x)).numpy()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-6


def test_complex_awgn_power_and_seed():
    n = complex_awgn(RNG(2), (4, 50000), power=0.3)
    assert n.dtype == np.complex64 and n.shape == (4, 50000)
    assert abs(np.mean(np.abs(n) ** 2) / 0.3 - 1) < 0.02
    assert abs(np.mean(n.real ** 2) - np.mean(n.imag ** 2)) < 0.01
    np.testing.assert_array_equal(n, complex_awgn(RNG(2), (4, 50000), power=0.3))


@pytest.mark.parametrize("snr_db", [0.0, 12.0])
def test_add_noise_snr_measured(snr_db):
    x = 3.0 * np.exp(2j * np.pi * 0.01 * np.arange(200000)).astype(np.complex64)
    for y in (tch.add_noise_snr(RNG(3), torch.as_tensor(x), snr_db).numpy(),
              tch.add_noise_snr(RNG(3), x, snr_db)):
        assert y.dtype == np.complex64
        meas = 10 * np.log10(np.mean(np.abs(x) ** 2) / np.mean(np.abs(y - x) ** 2))
        assert abs(meas - snr_db) < 0.2


def test_fading_and_phase_noise_statistics():
    taps = np.stack([tch.rayleigh_taps(RNG(s), 5, decay=2.0) for s in range(4000)])
    assert taps.dtype == np.complex64
    assert abs(np.mean(np.sum(np.abs(taps) ** 2, axis=1)) - 1.0) < 0.05
    pdp = np.mean(np.abs(taps) ** 2, axis=0)
    assert np.all(np.diff(pdp) < 0)
    g = tch.jakes_fading(RNG(5), 200000, doppler=0.01)
    assert abs(np.mean(np.abs(g) ** 2) - 1.0) < 0.1
    ph = np.stack([np.angle(tch.phase_noise(RNG(s), 400, 1e-4)) for s in range(2000)])
    var = np.var(ph[:, -1])
    assert abs(var / (2 * np.pi * 1e-4 * 400) - 1) < 0.1
    np.testing.assert_array_equal(tch.jakes_fading(RNG(5), 100, 0.01),
                                  tch.jakes_fading(RNG(5), 100, 0.01))
