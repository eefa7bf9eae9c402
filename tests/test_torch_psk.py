"""Port vs JAX package: the M-PSK chains, ``chains/psk`` (complex tier) and
``chains/psk_planes`` (the tail after the bank kernels).

Contracts:

- ``psk_apply`` against JAX on the reference's cases (orders 2, 4, 8 clean;
  QPSK at 20 dB; 16 channels): indices equal, soft symbols to rel L2 < 1e-4,
  SER 0 after ``diff_decode`` where the reference asks for it;
- ``psk_demod_stream`` equal to ``psk_apply`` over the same blocks by
  ``torch.equal``, and its indices equal to JAX's;
- against the C++ oracle's ``psk_demod``: equal after ``diff_decode``;
- the committed ``qpsk_256sym`` fixture: indices equal to the gold, SER 0
  after ``diff_decode``;
- ``psk_demod_planes`` and ``psk_demod_bank_stats`` (interp on and off, and
  class-major) against JAX on the same bank output of a modulated wideband
  (M = 8, 256 symbols): indices equal, SER 0. The two tails estimate the
  carrier from different samples, so they are compared to each other only
  after ``diff_decode``.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu.chains import psk as jp
from srcdsp_tpu.chains import psk_planes as jpp
from srcdsp_tpu.kernels import bank_pallas as jb
from srcdsp_tpu_torch import oracle as toracle
from srcdsp_tpu_torch.chains import psk as tp
from srcdsp_tpu_torch.chains import psk_planes as tpp
from srcdsp_tpu_torch.chains.fsk_planes import make_timing_tone
from srcdsp_tpu_torch.io.capture import read_capture
from srcdsp_tpu_torch.kernels import bank_pallas as tb
from srcdsp_tpu_torch.ops.cpow import cpow
from srcdsp_tpu_torch.ops.resample import resample_full
from srcdsp_tpu_torch.testing.signals import psk_symbols, psk_wideband, tone, upsample_pulse
from tests.torch_threads import one_torch_thread  # noqa: F401

FIX = Path(__file__).resolve().parent / "fixtures"


def ser_diff(data, rx_idx, order, settle=20, lags=16) -> float:
    """Symbol error rate after differential decode, best over small lags."""
    d = tp.diff_decode(torch.as_tensor(np.asarray(rx_idx)), order).numpy()
    b = np.asarray(data)
    best = 1.0
    for lag in range(-lags, lags + 1):
        bs, rs = settle + max(lag, 0), settle + max(-lag, 0)
        n = min(b.shape[-1] - bs, d.shape[-1] - rs)
        if n > 0:
            best = min(best, float(np.mean(b[..., bs:bs + n] != d[..., rs:rs + n])))
    return best


def _tx(seed, nsym, order, decim, sps, center, channel_shape=(), snr_db=None):
    """Pulse-shaped differentially encoded random symbols mixed to `center`."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, order, size=(*channel_shape, nsym), dtype=np.int32)
    tx = tp.diff_encode(torch.from_numpy(data), order).numpy()
    sym = np.exp(2j * np.pi * (tx + tp.constellation_offset(order)) / order).astype(np.complex64)
    params = tp.make_psk_params(center, decim=decim, sps=sps, order=order, device="cpu")
    x = resample_full(params.taps, torch.from_numpy(sym), up=decim * sps, down=1).numpy()
    x = (x * tone(x.shape[-1], center)).astype(np.complex64)
    if snr_db is not None:
        p = float(np.mean(np.abs(x) ** 2)) * 10 ** (-snr_db / 10)
        x = (x + np.sqrt(p / 2) * (rng.standard_normal(x.shape)
                                   + 1j * rng.standard_normal(x.shape))).astype(np.complex64)
    return data, params, x


def _both(x, order, decim, sps, center, channel_shape=()):
    tpar = tp.make_psk_params(center, decim=decim, sps=sps, order=order, device="cpu")
    jpar = jp.make_psk_params(center, decim=decim, sps=sps, order=order)
    _, (ti, ts) = tp.psk_apply(tpar, tp.psk_init(tpar, channel_shape), torch.from_numpy(x))
    _, (ji, js) = jp.psk_apply(jpar, jp.psk_init(jpar, channel_shape), jnp.asarray(x))
    return ti, ts, np.asarray(ji), np.asarray(js)


@pytest.mark.parametrize("order,snr_db,channels", [(2, None, ()), (4, None, ()), (8, None, ()),
                                                   (4, 20.0, ()), (4, None, (16,))])
def test_psk_apply_matches_jax(order, snr_db, channels):
    nsym = 1024 if snr_db else (256 if channels else 512)
    data, params, x = _tx(order + len(channels), nsym, order, 2, 4, 0.17, channels, snr_db)
    ti, ts, ji, js = _both(x, order, 2, 4, 0.17, channels)
    assert ti.dtype == torch.int32 and ts.dtype == torch.complex64
    np.testing.assert_array_equal(ti.numpy(), ji)
    assert np.linalg.norm(ts.numpy() - js) / np.linalg.norm(js) < 1e-4
    for c in np.ndindex(*channels):
        assert ser_diff(data[c], ti[c].numpy(), order) <= (0.01 if snr_db else 0.0)


def test_params_and_state_match_jax():
    tpar = tp.make_psk_params(0.17, decim=2, sps=4, order=4, device="cpu")
    jpar = jp.make_psk_params(0.17, decim=2, sps=4, order=4)
    assert int(tpar.freq_word) == int(np.asarray(jpar.freq_word))
    np.testing.assert_array_equal(tpar.taps.numpy(), np.asarray(jpar.taps))
    st = tp.psk_init(tpar, (3,))
    assert tuple(st.timing.last.shape) == (3, 5) and st.timing.last.dtype == torch.complex64
    assert tuple(st.fir.tail.shape) == (3, tpar.taps.shape[0] - 1)


def test_psk_stream_equals_blocks_and_jax():
    order, decim, sps = 4, 2, 4
    data, params, x = _tx(4, 512, order, decim, sps, 0.17)
    block = x.shape[-1] // 4
    idx, soft = tp.psk_demod_stream(params, torch.from_numpy(x), block)
    st = tp.psk_init(params)
    parts = []
    for i in range(4):
        st, (bi, bs) = tp.psk_apply(params, st, torch.from_numpy(x[i * block:(i + 1) * block]))
        parts.append((bi, bs))
    assert torch.equal(idx, torch.cat([p[0] for p in parts]))
    assert torch.equal(soft, torch.cat([p[1] for p in parts]))
    jidx, _ = jp.psk_demod_stream(jp.make_psk_params(0.17, decim=decim, sps=sps, order=order),
                                  jnp.asarray(x), block=block)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert ser_diff(data, idx.numpy(), order) < 0.01
    with pytest.raises(ValueError, match="divisible"):
        tp.psk_demod_stream(params, torch.from_numpy(x[:-8]), block)


@pytest.mark.parametrize("order", [2, 4])
def test_psk_matches_oracle(order):
    data, params, x = _tx(7 + order, 512, order, 2, 4, 0.17)
    _, (ti, _) = tp.psk_apply(params, tp.psk_init(params), torch.from_numpy(x))
    ref = toracle.psk_demod(x, 0.17, params.taps.numpy(), 2, 4, order)
    d = tp.diff_decode(ti, order).numpy()
    dref = tp.diff_decode(torch.from_numpy(ref), order).numpy()
    np.testing.assert_array_equal(d[1:], dref[1:])
    assert ser_diff(data, ref, order) == 0.0


def test_slice_diff_and_symbols():
    order = 4
    idx = torch.tensor([0, 1, 3, 2, 2, 0, 1], dtype=torch.int32)
    assert torch.equal(tp.diff_decode(tp.diff_encode(idx, order), order), idx)
    np.testing.assert_array_equal(tp.diff_encode(idx, order).numpy(),
                                  np.asarray(jp.diff_encode(jnp.asarray(idx.numpy()), order)))
    off = tp.constellation_offset(order)
    k, sym = psk_symbols(np.random.default_rng(0), 64, order, (2,))
    assert k.shape == sym.shape == (2, 64) and sym.dtype == np.complex64
    np.testing.assert_array_equal(tp.psk_slice(torch.from_numpy(sym), order, off).numpy(), k)
    pts = np.exp(1j * 2 * np.pi * (idx.numpy() + off) / order).astype(np.complex64)
    np.testing.assert_array_equal(tp.psk_slice(torch.from_numpy(pts), order, off), idx)
    x = torch.tensor([1 + 2j, -0.5 + 0.25j], dtype=torch.complex64)
    for n in (1, 2, 3, 4, 8):
        np.testing.assert_allclose(torch.complex(*cpow(x.real, x.imag, n)).numpy(),
                                   x.numpy() ** n, rtol=1e-6)


def test_upsample_pulse_matches_jax():
    from srcdsp_tpu.testing.signals import upsample_pulse as jup
    from srcdsp_tpu_torch.ops.window import root_raised_cosine

    _, sym = psk_symbols(np.random.default_rng(1), 40, 4)
    pulse = root_raised_cosine(4, 4)
    got = upsample_pulse(sym, 4, pulse)
    assert isinstance(got, np.ndarray) and got.shape == (160,)
    np.testing.assert_allclose(got, np.asarray(jup(jnp.asarray(sym), 4, jnp.asarray(pulse))),
                               atol=1e-6)
    assert torch.equal(upsample_pulse(torch.from_numpy(sym), 4, pulse), torch.from_numpy(got))


def test_qpsk_fixture_matches_gold():
    meta = json.loads((FIX / "qpsk_256sym.fixture.json").read_text())
    x, _ = read_capture(str(FIX / "qpsk_256sym.ci16"))
    pp = tp.make_psk_params(meta["center"], decim=meta["decim"], sps=meta["sps"],
                            order=meta["order"], device="cpu")
    _, (idx, _) = tp.psk_apply(pp, tp.psk_init(pp), torch.from_numpy(np.ascontiguousarray(x)))
    gold = np.load(FIX / "qpsk_256sym_gold_idx.npy")
    np.testing.assert_array_equal(idx.numpy(), gold)
    data = np.load(FIX / "qpsk_256sym_data.npy")
    assert ser_diff(data, gold, meta["order"], settle=24) == 0.0


M, NSYM, ORDER, SPS, B_K = 8, 256, 4, 4, 128


@pytest.fixture(scope="module")
def wideband():
    """Bank outputs (JAX's K13 in interpret mode, standard and class-major)
    of an 8-channel QPSK wideband, and the data."""
    data, proto, wb = psk_wideband(np.random.default_rng(3), M, NSYM, ORDER, SPS, device="cpu")
    wb = wb.numpy()
    out = {}
    for cm in (False, True):
        jf, hc = jb.make_bank_psk_kernel(proto, M, sps=SPS, order=ORDER, b_k=B_K,
                                         class_major=cm, interpret=True)
        k = (wb.size // M // B_K) * B_K
        flat = np.zeros((2, (hc + k) * M), np.float32)
        flat[0, hc * M:], flat[1, hc * M:] = wb.real[:k * M], wb.imag[:k * M]
        xp = tb.phase_major(torch.from_numpy(flat), M, hc)
        y, st = jf(jnp.asarray(xp.numpy()))
        out[cm] = (np.array(y), np.array(st), xp, proto)
    return data, out


@pytest.mark.parametrize("class_major,interp", [(False, True), (False, False), (True, False)])
def test_bank_stats_tail_matches_jax(wideband, class_major, interp):
    data, out = wideband
    y, st, xp, proto = out[class_major]
    cmb = B_K if class_major else 0
    _, (ji, _) = jpp.psk_demod_bank_stats(jnp.asarray(y[:M]), jnp.asarray(y[M:]), jnp.asarray(st),
                                          SPS, ORDER, offset=0.5, interp=interp,
                                          class_major_b_k=cmb)
    acc, (ti, (sr, si)) = tpp.psk_demod_bank_stats(
        torch.from_numpy(y[:M]), torch.from_numpy(y[M:]), torch.from_numpy(st), SPS, ORDER,
        offset=0.5, interp=interp, class_major_b_k=cmb)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert len(acc) == 4 and tuple(sr.shape) == tuple(ti.shape) == (M, y.shape[1] // SPS)
    # the whole port path: the plain K13 and the port's tail
    kb, _ = tb.make_bank_psk_kernel(proto, M, sps=SPS, order=ORDER, b_k=B_K,
                                    class_major=class_major, device="cpu")
    py, pst = kb(xp)
    _, (pi_, _) = tpp.psk_demod_bank_stats(py[:M], py[M:], pst, SPS, ORDER, offset=0.5,
                                           interp=interp, class_major_b_k=cmb)
    for c in range(M):
        assert ser_diff(data[c], pi_[c].numpy(), ORDER, settle=30, lags=32) == 0.0, c


def test_planes_tail_matches_jax(wideband):
    data, out = wideband
    y, _, _, _ = out[False]
    k = y.shape[1]
    tc, ts = make_timing_tone(k, SPS)
    _, (ji, _) = jpp.psk_demod_planes(jnp.asarray(y[:M]), jnp.asarray(y[M:]), SPS, ORDER,
                                      jnp.asarray(tc), jnp.asarray(ts), offset=0.5)
    _, (ti, _) = tpp.psk_demod_planes(torch.from_numpy(y[:M]), torch.from_numpy(y[M:]), SPS, ORDER,
                                      torch.from_numpy(tc), torch.from_numpy(ts), offset=0.5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _, (bi, _) = tpp.psk_demod_bank_stats(torch.from_numpy(y[:M]), torch.from_numpy(y[M:]),
                                          torch.from_numpy(out[False][1]), SPS, ORDER, offset=0.5)
    for c in range(M):
        assert ser_diff(data[c], ti[c].numpy(), ORDER, settle=30, lags=32) == 0.0, c
        # the tails agree after the differential decode
        d1 = tp.diff_decode(ti[c], ORDER)[30:]
        d2 = tp.diff_decode(bi[c], ORDER)[30:]
        assert torch.equal(d1, d2), c


def test_cpow_matches_jax():
    rng = np.random.default_rng(0)
    yr, yi = rng.standard_normal((2, 4, 16)).astype(np.float32)
    for order in (2, 3, 4, 8):
        pr, pi = cpow(torch.from_numpy(yr), torch.from_numpy(yi), order)
        jr, ji = jpp._cpow(jnp.asarray(yr), jnp.asarray(yi), order)
        np.testing.assert_allclose(pr.numpy(), np.asarray(jr), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(pi.numpy(), np.asarray(ji), rtol=1e-5, atol=1e-5)
