"""Port vs JAX package: the square-QAM chain (``chains/qam``), the soft
demappers (``demap``) and the transmit chains (``chains/tx``).

Contracts:

- host tables equal: QAM, PSK and APSK constellations (complex64 bit for
  bit), the rotation map;
- `qam_slice`, `qam_slice_planes` (indices and nearest points), `qam_map`,
  `bits_to_indices` and `quad_diff_encode` / `quad_diff_decode` equal;
- `qam_apply` on the reference's round trip (QAM16 through the tx chain at
  decim 2, sps 4): indices equal, soft symbols to rel L2 < 1e-4 (cos/sin and
  summation order differ between the frameworks), SER 0 after the
  quadrant-differential decode; `qam_demod_stream` equal to `qam_apply` over
  the same blocks;
- `maxlog_llr`, `qam_llr`, `psk_llr`, `qam_llr_bitplanes` and
  `qam_llr_planes`: within 1e-5 relative to the largest LLR, hard decisions
  equal away from exact ties (|llr| > 1e-4);
- `linear_tx_apply` and `cpm_tx_apply` (CPFSK, GMSK): the stream in blocks
  equal to one block (torch.equal), within 2e-6 of JAX (the phase words of
  CPM bit for bit), and `psk_map` within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu import demap as jd
from srcdsp_tpu.chains import qam as jq
from srcdsp_tpu.chains import tx as jtx
from srcdsp_tpu_torch import demap as td
from srcdsp_tpu_torch.chains import qam as tq
from srcdsp_tpu_torch.chains import tx as ttx
from tests.torch_threads import one_torch_thread  # noqa: F401

ORDERS = [4, 16, 64]


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("order", ORDERS)
def test_tables_equal(order):
    np.testing.assert_array_equal(tq.qam_constellation(order), np.asarray(jq.qam_constellation(order)))
    np.testing.assert_array_equal(tq.rotation_map(order), np.asarray(jq.rotation_map(order)))
    np.testing.assert_array_equal(td.psk_points(order), np.asarray(jd.psk_points(order)))
    assert tq.qam_scale(order) == jq.qam_scale(order)


def test_apsk_and_level_errors():
    for order in (16, 32):
        np.testing.assert_array_equal(td.apsk_constellation(order),
                                      np.asarray(jd.apsk_constellation(order)))
    np.testing.assert_array_equal(td.apsk_constellation(16, 3.0),
                                  np.asarray(jd.apsk_constellation(16, 3.0)))
    for bad in ((8, None), (16, (1.0, 2.0)), (32, 2.0)):
        with pytest.raises(ValueError):
            td.apsk_constellation(*bad)
    with pytest.raises(ValueError, match="square power of 4"):
        tq.qam_constellation(8)


@pytest.mark.parametrize("order", ORDERS)
def test_slicers_and_quad_diff_equal(order):
    rng = np.random.default_rng(order)
    y = (rng.standard_normal(400) + 1j * rng.standard_normal(400)).astype(np.complex64) * 0.8
    np.testing.assert_array_equal(tq.qam_slice(torch.as_tensor(y), order).numpy(),
                                  np.asarray(jq.qam_slice(jnp.asarray(y), order)))
    ti, (tr, ti_) = tq.qam_slice_planes(torch.as_tensor(y.real.copy()),
                                        torch.as_tensor(y.imag.copy()), order)
    ji, (jr, ji_) = jq.qam_slice_planes(jnp.asarray(y.real), jnp.asarray(y.imag), order)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(ti_.numpy(), np.asarray(ji_))
    idx = rng.integers(0, order, (2, 300))
    enc = tq.quad_diff_encode(torch.as_tensor(idx), order)
    np.testing.assert_array_equal(enc.numpy(), np.asarray(jq.quad_diff_encode(jnp.asarray(idx),
                                                                              order)))
    # a pi/2 slip on every symbol cancels in the decode (but the first)
    rm = torch.as_tensor(tq.rotation_map(order), dtype=torch.int64)
    dec = tq.quad_diff_decode(rm[enc.to(torch.int64)], order)
    np.testing.assert_array_equal(dec.numpy()[:, 1:], idx[:, 1:])
    np.testing.assert_array_equal(ttx.qam_map(torch.as_tensor(idx), order).numpy(),
                                  np.asarray(jtx.qam_map(jnp.asarray(idx), order)))
    bits = rng.integers(0, 2, (3, 24))
    np.testing.assert_array_equal(ttx.bits_to_indices(torch.as_tensor(bits), 4).numpy(),
                                  np.asarray(jtx.bits_to_indices(jnp.asarray(bits), 4)))


def test_qam_chain_close_to_jax():
    order, decim, sps, center = 16, 2, 4, 0.11
    data = np.random.default_rng(5).integers(0, order, 512)
    tx_idx = np.asarray(jq.quad_diff_encode(jnp.asarray(data), order))
    rxp = jq.make_qam_params(center, decim=decim, sps=sps, order=order)
    txp = jtx.make_linear_tx(center, rxp.taps, sps=decim * sps)
    _, x = jtx.linear_tx_apply(txp, jtx.linear_tx_init(txp), jtx.qam_map(jnp.asarray(tx_idx), order))
    x = np.asarray(x)
    _, (jidx, jsoft) = jq.qam_apply(rxp, jq.qam_init(rxp), jnp.asarray(x))
    tp = tq.make_qam_params(center, decim=decim, sps=sps, order=order, device="cpu")
    np.testing.assert_array_equal(tp.taps.numpy(), np.asarray(rxp.taps))
    _, (tidx, tsoft) = tq.qam_apply(tp, tq.qam_init(tp), torch.as_tensor(x))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    assert _rel(tsoft.numpy(), np.asarray(jsoft)) < 1e-4
    d = tq.quad_diff_decode(tidx, order).numpy()
    best = min(float(np.mean(data[20:420] != d[20 + lag:420 + lag])) for lag in range(0, 17))
    assert best == 0.0
    block = 1024
    sidx, ssoft = tq.qam_demod_stream(tp, torch.as_tensor(x), block)
    st = tq.qam_init(tp)
    parts = []
    for b0 in range(0, x.shape[-1], block):
        st, (i, _) = tq.qam_apply(tp, st, torch.as_tensor(x[b0:b0 + block]))
        parts.append(i)
    assert torch.equal(sidx, torch.cat(parts))
    with pytest.raises(ValueError, match="not divisible"):
        tq.qam_demod_stream(tp, torch.as_tensor(x[:1000]), block)


def _llr_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    sure = np.abs(want) > 1e-4
    np.testing.assert_array_equal((got < 0)[sure], (want < 0)[sure])


@pytest.mark.parametrize("order", ORDERS)
def test_demappers_close(order):
    rng = np.random.default_rng(order + 1)
    y = (rng.standard_normal((3, 200)) + 1j * rng.standard_normal((3, 200))).astype(np.complex64)
    y *= 0.7
    _llr_close(td.qam_llr(torch.as_tensor(y), order, 0.1), jd.qam_llr(jnp.asarray(y), order, 0.1))
    _llr_close(td.psk_llr(torch.as_tensor(y), order, 0.2), jd.psk_llr(jnp.asarray(y), order, 0.2))
    labels = rng.permutation(order)
    _llr_close(td.maxlog_llr(torch.as_tensor(y), td.psk_points(order), 0.5, labels),
               jd.maxlog_llr(jnp.asarray(y), jd.psk_points(order), 0.5, labels))
    yr, yi = torch.as_tensor(y.real.copy()), torch.as_tensor(y.imag.copy())
    planes = td.qam_llr_bitplanes(yr, yi, order, 0.25)
    jplanes = jd.qam_llr_bitplanes(jnp.asarray(y.real), jnp.asarray(y.imag), order, 0.25)
    assert len(planes) == len(jplanes) == order.bit_length() - 1
    for a, b in zip(planes, jplanes):
        _llr_close(a, b)
    _llr_close(td.qam_llr_planes(yr, yi, order), jd.qam_llr_planes(jnp.asarray(y.real),
                                                                   jnp.asarray(y.imag), order))
    with pytest.raises(ValueError, match="power of two"):
        td.maxlog_llr(torch.as_tensor(y), np.ones(3, np.complex64), 1.0)


def test_linear_tx_stream_and_close_to_jax():
    from srcdsp_tpu_torch.ops.window import root_raised_cosine

    taps = root_raised_cosine(4, 8, beta=0.35)
    idx = np.random.default_rng(2).integers(0, 16, (2, 256))
    centers = np.asarray([0.07, -0.12])
    tp = ttx.make_linear_tx(centers, taps, 4, device="cpu")
    sym = ttx.qam_map(torch.as_tensor(idx), 16)
    _, one = ttx.linear_tx_apply(tp, ttx.linear_tx_init(tp, (2,)), sym)
    st, parts = ttx.linear_tx_init(tp, (2,)), []
    for b0 in range(0, 256, 64):
        st, y = ttx.linear_tx_apply(tp, st, sym[:, b0:b0 + 64])
        parts.append(y)
    assert torch.equal(torch.cat(parts, dim=-1), one)
    for c in range(2):
        jp = jtx.make_linear_tx(float(centers[c]), taps, 4)
        _, want = jtx.linear_tx_apply(jp, jtx.linear_tx_init(jp), jtx.qam_map(jnp.asarray(idx[c]),
                                                                               16))
        assert np.abs(one[c].numpy() - np.asarray(want)).max() < 2e-6
    pidx = np.arange(16) % 8
    assert np.abs(ttx.psk_map(torch.as_tensor(pidx), 8).numpy()
                  - np.asarray(jtx.psk_map(jnp.asarray(pidx), 8))).max() < 1e-6


@pytest.mark.parametrize("kind", ["cpfsk", "gmsk"])
def test_cpm_tx_stream_and_close_to_jax(kind):
    sps = 8
    bits = np.random.default_rng(4).integers(0, 2, 256)
    if kind == "cpfsk":
        jp, tp = jtx.make_cpfsk_tx(0.05, sps, 0.03), ttx.make_cpfsk_tx(0.05, sps, 0.03, device="cpu")
    else:
        jp, tp = jtx.make_gmsk_tx(0.05, sps, bt=0.3), ttx.make_gmsk_tx(0.05, sps, bt=0.3,
                                                                       device="cpu")
    np.testing.assert_array_equal(tp.words.numpy(), np.asarray(jp.words))
    jst, want = jtx.cpm_tx_apply(jp, jtx.cpm_tx_init(jp), jnp.asarray(bits))
    tst, got = ttx.cpm_tx_apply(tp, ttx.cpm_tx_init(tp), torch.as_tensor(bits))
    assert np.abs(got.numpy() - np.asarray(want)).max() < 2e-6
    assert int(tst.phase) == int(jst.phase)
    np.testing.assert_array_equal(tst.hist.numpy(), np.asarray(jst.hist))
    st, parts = ttx.cpm_tx_init(tp), []
    for b0, b1 in ((0, 37), (37, 100), (100, 256)):
        st, y = ttx.cpm_tx_apply(tp, st, torch.as_tensor(bits[b0:b1]))
        parts.append(y)
    assert torch.equal(torch.cat(parts), got)
