"""Port vs JAX package: the bank kernels' plain versions, K12
(``make_bank_kernel``) and K13 (``make_bank_psk_kernel``), in
``kernels/bank_pallas``.

Contracts:

- geometry (hist_cols = P - 1 rounded up to 128) and every ValueError as the
  JAX factories raise them;
- K12's plain version against JAX ``make_bank_kernel(interpret=True)`` at
  M = 8, b_k 16 and 128, manual and pipelined forms: SNR > 110 dB; against
  the complex tier ``channelize_full`` on the same stream: > 110 dB;
- ``bank_os2_pallas`` against JAX's: > 110 dB;
- K13's plain version: Y equal to K12's plain Y by ``torch.equal``; stats
  within rel 1e-5 (L2 over the stats array: single entries are sums with
  cancellation) of JAX's; class-major lanes equal to the standard lanes
  permuted, by ``torch.equal``; Y in class-major order against JAX's
  class-major Y: > 110 dB (the reference permutes with a one-pass matmul,
  exact on the CPU).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu.kernels import bank_pallas as jb
from srcdsp_tpu_torch.chains.channelizer import channelize_full, design_prototype
from srcdsp_tpu_torch.kernels import bank_pallas as tb

M = 8


def _snr_db(ref, got) -> float:
    ref, got = np.asarray(ref), np.asarray(got)
    err = np.mean(np.abs(got - ref) ** 2)
    return float(10 * np.log10(np.mean(np.abs(ref) ** 2) / (err + 1e-30)))


def _planes(seed, hist_cols, k, m=M):
    return np.random.default_rng(seed).standard_normal((2, m, hist_cols + k)).astype(np.float32)


@pytest.mark.parametrize("m,tpp", [(8, 4), (16, 8), (64, 8), (4, 40), (2, 300)])
def test_hist_cols_equals_jax(m, tpp):
    h = design_prototype(m, tpp)
    _, hc = tb.make_bank_kernel(h, m, b_k=128, device="cpu")
    _, jhc = jb.make_bank_kernel(h, m, b_k=128, interpret=True)
    _, hc2 = tb.make_bank_psk_kernel(h, m, sps=4, b_k=128, device="cpu")
    assert hc == jhc == hc2 == ((tpp + 127) // 128) * 128


@pytest.mark.parametrize("b_k,pipelined", [(16, False), (16, None), (128, False), (128, True),
                                           (128, None)])
def test_k12_plain_matches_jax(b_k, pipelined):
    h = design_prototype(M, 4)
    jf, hc = jb.make_bank_kernel(h, M, b_k=b_k, pipelined=pipelined, interpret=True)
    tf, _ = tb.make_bank_kernel(h, M, b_k=b_k, pipelined=pipelined, device="cpu")
    x = _planes(b_k, hc, 4 * b_k)
    got = tf(torch.from_numpy(x))
    assert tuple(got.shape) == (2 * M, 4 * b_k) and got.dtype == torch.float32
    assert _snr_db(np.asarray(jf(jnp.asarray(x))), got.numpy()) > 110


def test_k12_plain_is_the_channelizer():
    """From zero history, Y equals chains.channelizer on the flat stream."""
    h = design_prototype(M, 8)
    fn, hc = tb.make_bank_kernel(h, M, b_k=64, device="cpu")
    k = 256
    rng = np.random.default_rng(1)
    xs = (rng.standard_normal(k * M) + 1j * rng.standard_normal(k * M)).astype(np.complex64)
    flat = np.zeros((2, (hc + k) * M), np.float32)
    flat[0, hc * M:], flat[1, hc * M:] = xs.real, xs.imag
    xp = tb.phase_major(torch.from_numpy(flat), M, hc)
    np.testing.assert_array_equal(xp.numpy(), np.asarray(jb.phase_major(jnp.asarray(flat), M, hc)))
    y = fn(xp).numpy()
    ref = channelize_full(h, torch.from_numpy(xs), M).numpy()
    assert _snr_db(ref, y[:M] + 1j * y[M:]) > 110


def test_bank_os2_matches_jax():
    h = design_prototype(M, 4)
    b_k = 32
    jf, hc = jb.make_bank_kernel(h, M, b_k=b_k, interpret=True)
    tf, _ = tb.make_bank_kernel(h, M, b_k=b_k, device="cpu")
    flat = np.random.default_rng(2).standard_normal((2, (hc + 4 * b_k) * M)).astype(np.float32)
    flat[:, :hc * M] = 0.0
    got = tb.bank_os2_pallas(tf, hc, torch.from_numpy(flat), M)
    ref = np.asarray(jb.bank_os2_pallas(jf, hc, jnp.asarray(flat), M))
    assert tuple(got.shape) == ref.shape == (2 * M, 8 * b_k)
    assert _snr_db(ref, got.numpy()) > 110


@pytest.mark.parametrize("b_k,sps,order", [(16, 4, 4), (128, 4, 4), (128, 8, 2), (96, 3, 8)])
def test_k13_plain_matches_jax_and_k12(b_k, sps, order):
    h = design_prototype(M, 4)
    k12, hc = tb.make_bank_kernel(h, M, b_k=b_k, device="cpu")
    x = torch.from_numpy(_planes(b_k + sps, hc, 3 * b_k))
    y12 = k12(x)
    ys = {}
    for cm in (False, True):
        tf, _ = tb.make_bank_psk_kernel(h, M, sps=sps, order=order, b_k=b_k, class_major=cm,
                                        device="cpu")
        jf, _ = jb.make_bank_psk_kernel(h, M, sps=sps, order=order, b_k=b_k, class_major=cm,
                                        interpret=True)
        y, st = tf(x)
        jy, jst = jf(jnp.asarray(x.numpy()))
        jst = np.asarray(jst)
        assert tuple(st.shape) == jst.shape == (3, M, tb.STATS_LANES)
        assert np.linalg.norm(st.numpy() - jst) / np.linalg.norm(jst) < 1e-5
        assert not st[:, :, 2 + 2 * sps:].any()
        assert _snr_db(np.asarray(jy), y.numpy()) > 110
        ys[cm] = (y, st)
    assert torch.equal(ys[False][0], y12)
    assert torch.equal(ys[True][1], ys[False][1])
    perm = tb.class_major_index(b_k, sps, "cpu")
    std = ys[False][0].reshape(2 * M, 3, b_k)
    assert torch.equal(ys[True][0], std[..., perm].reshape(2 * M, 3 * b_k))
    # class-major lane n holds frame (n % (b_k/sps)) * sps + n // (b_k/sps)
    n = 5
    assert int(perm[n]) == (n % (b_k // sps)) * sps + n // (b_k // sps)


def test_factories_raise_as_jax():
    h = design_prototype(M, 4)
    for make in (lambda **kw: jb.make_bank_psk_kernel(h, M, interpret=True, **kw),
                 lambda **kw: tb.make_bank_psk_kernel(h, M, device="cpu", **kw)):
        with pytest.raises(ValueError, match="power of two"):
            make(sps=4, order=3)
        with pytest.raises(ValueError, match="power of two"):
            make(sps=4, order=1)
        with pytest.raises(ValueError, match="% sps"):
            make(sps=3, b_k=128)
        with pytest.raises(ValueError, match="pipelined"):
            make(sps=4, b_k=64, pipelined=True)
    for make in (lambda **kw: jb.make_bank_kernel(h, M, interpret=True, **kw),
                 lambda **kw: tb.make_bank_kernel(h, M, device="cpu", **kw)):
        with pytest.raises(ValueError, match="pipelined"):
            make(b_k=64, pipelined=True)
    fn, hc = tb.make_bank_kernel(h, M, b_k=64, device="cpu")
    jfn, _ = jb.make_bank_kernel(h, M, b_k=64, interpret=True)
    bad = np.zeros((2, M, hc + 100), np.float32)
    with pytest.raises(ValueError, match="not a multiple of b_k"):
        jfn(jnp.asarray(bad))
    with pytest.raises(ValueError, match="not a multiple of b_k"):
        fn(torch.from_numpy(bad))
    with pytest.raises(ValueError, match="shape"):
        fn(torch.zeros((2, M + 1, hc + 64)))
    with pytest.raises(ValueError, match="float32"):
        fn(torch.zeros((2, M, hc + 64), dtype=torch.float64))
