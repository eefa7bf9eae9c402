"""Port vs JAX package: the block equalizers, ``chains/ofdm``,
``chains/ofdm_planes``, ``chains/scfde`` and ``chains/scfde_planes``, and the
three ``testing/signals`` generators they and the OOK chain use.

Fixtures (numpy, seeded), the reference's own (``tests/unit/test_ofdm*.py``,
``test_scfde*.py``) cut to 2 channels: 16-QAM OFDM (nfft 64, cp 16, 52
active) through a two-tap channel with residual phase and noise; the full
receiver on garbage | preamble | pilot | data through multipath, CFO 0.19
and 28 dB; QPSK SC-FDE (n 256, cp 32) through a three-tap channel. The same
samples go through JAX (jitted where the reference jits) and the port (CPU);
the receivers' JAX runs happen once per module (`ref`).

Contracts:

- bit for bit: `zadoff_chu`, `ook_baseband`, `manchester_encode`; the OFDM
  symbol map (`ofdm_grid`, the bins before the IFFT) and `scfde_tx`;
- decisions equal: every OFDM / SC-FDE index, `coarse_start` and
  `ofdm_rx`'s start;
- float outputs (open loop) within rel L2 1e-5: time-domain samples, the
  preamble, the S&C metric, soft symbols and planes, the channel estimate;
  the CFO estimates within 1e-5 absolute. Measured here: <= 5.8e-7; the
  FFTs are pocketfft (torch) against XLA's, the DFT matmuls MKL against
  Eigen.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu.chains import ofdm as jo
from srcdsp_tpu.chains import ofdm_planes as jop
from srcdsp_tpu.chains import scfde as jsc
from srcdsp_tpu.chains import scfde_planes as jscp
from srcdsp_tpu.chains.qam import qam_constellation, qam_slice as jqam_slice
from srcdsp_tpu.testing import signals as jsig
from srcdsp_tpu_torch import convert
from srcdsp_tpu_torch.chains import ofdm as to
from srcdsp_tpu_torch.chains import ofdm_planes as top
from srcdsp_tpu_torch.chains import scfde as tsc
from srcdsp_tpu_torch.chains import scfde_planes as tscp
from srcdsp_tpu_torch.chains.qam import qam_slice
from srcdsp_tpu_torch.testing import signals as tsig
from tests.torch_threads import one_torch_thread  # noqa: F401

C = 2
REL = 1e-5
PLANE_CASES = [(16, 1), (64, 1), (16, 2)]
SCFDE_SNRS = [200.0, 1e6]


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------- generators ----------

@pytest.mark.parametrize("root,length", [(25, 256), (1, 63), (7, 139), (29, 64)])
def test_zadoff_chu_bit_for_bit(root, length):
    got = tsig.zadoff_chu(root, length)
    assert got.dtype == np.complex64
    np.testing.assert_array_equal(got, jsig.zadoff_chu(root, length))


def test_zadoff_chu_gcd_error():
    with pytest.raises(ValueError, match="gcd"):
        tsig.zadoff_chu(4, 64)


@pytest.mark.parametrize("depth,rise", [(1.0, 0), (0.5, 0), (1.0, 3), (0.7, 5)])
def test_ook_baseband_and_manchester_bit_for_bit(depth, rise):
    bits = np.random.default_rng(rise).integers(0, 2, (C, 37))
    got = tsig.ook_baseband(bits, 8, depth=depth, rise=rise)
    assert got.dtype == np.complex64
    np.testing.assert_array_equal(got, jsig.ook_baseband(bits, 8, depth=depth, rise=rise))
    np.testing.assert_array_equal(tsig.manchester_encode(bits), jsig.manchester_encode(bits))


# ---------- OFDM, complex tier ----------

def _pilot(spec, rng):
    """Known QPSK pilot points on all active bins."""
    return np.exp(2j * np.pi * (rng.integers(0, 4, spec.active.size) + 0.5) / 4).astype(
        np.complex64)


def _points(spec, rng, nsym):
    idx = rng.integers(0, spec.order, (nsym, spec.active.size))
    return idx, np.asarray(qam_constellation(spec.order))[idx]


@pytest.mark.parametrize("nfft,cp,na,order", [(64, 16, 52, 16), (128, 32, 56, 64)])
def test_ofdm_modulate_equal_to_jax(nfft, cp, na, order):
    tspec = to.make_ofdm_spec(nfft, cp, na, order)
    jspec = jo.make_ofdm_spec(nfft, cp, na, order)
    np.testing.assert_array_equal(tspec.active, jspec.active)
    _, pts = _points(tspec, np.random.default_rng(nfft), 6)
    grid = to.ofdm_grid(tspec, _t(pts))
    jgrid = jnp.zeros((6, nfft), jnp.complex64).at[:, jnp.asarray(jspec.active)].set(
        jnp.asarray(pts))
    np.testing.assert_array_equal(grid.numpy(), np.asarray(jgrid))
    got = to.ofdm_modulate(tspec, _t(pts))
    assert got.dtype == torch.complex64
    assert rel(got.numpy(), jo.ofdm_modulate(jspec, jnp.asarray(pts))) <= REL
    got = to.ofdm_modulate_windowed(tspec, _t(pts), cp // 4)
    assert rel(got.numpy(), jo.ofdm_modulate_windowed(jspec, jnp.asarray(pts), cp // 4)) <= REL
    with pytest.raises(ValueError, match="window"):
        to.ofdm_modulate_windowed(tspec, _t(pts), cp // 4 + 1)
    with pytest.raises(ValueError, match="even"):
        to.make_ofdm_spec(64, 16, 51)


def test_schmidl_cox_preamble_metric_and_start():
    """The preamble from the same QPSK angles as JAX's key draws; the
    metric and the start on the reference's noise + preamble at 313."""
    tspec, jspec = to.make_ofdm_spec(), jo.make_ofdm_spec()
    key = jax.random.PRNGKey(4)
    act_even = jspec.active[jspec.active % 2 == 0]
    ang = np.asarray(jax.random.randint(key, (act_even.size,), 0, 4)).astype(np.float32)
    jpre = np.asarray(jo.schmidl_cox_preamble(jspec, key))
    pre = to.preamble_from_angles(tspec, _t(ang))
    assert rel(pre.numpy(), jpre) <= REL
    body = pre[tspec.cp:].numpy()
    np.testing.assert_allclose(body[:32], body[32:], atol=1e-6)
    gen = to.schmidl_cox_preamble(tspec, np.random.default_rng(0), device="cpu").numpy()
    assert gen.shape == (80,) and gen.dtype == np.complex64
    np.testing.assert_allclose(gen[16:48], gen[48:], atol=1e-6)
    # Parseval: the same power over the FFT window whatever the QPSK draw
    assert abs(np.mean(np.abs(gen[16:]) ** 2) / np.mean(np.abs(jpre[16:]) ** 2) - 1) < 1e-5
    y = tsig.complex_awgn(np.random.default_rng(5), (1000,), 0.02)
    y[313:313 + 80] += jpre
    p, m = to.schmidl_cox_metric(_t(y), 64)
    jp, jm = jo.schmidl_cox_metric(jnp.asarray(y), 64)
    assert rel(p.numpy(), jp) <= REL and rel(m.numpy(), jm) <= REL
    start = int(to.coarse_start(m, 16))
    assert start == int(jo.coarse_start(jm, 16)) and abs(start - 313) <= 2


def _rx_capture(seed):
    """The reference's full-receiver fixture: garbage | preamble | pilot |
    20 data symbols | zeros, through a 3-tap channel, CFO +0.19, 28 dB."""
    spec = jo.make_ofdm_spec()
    rng = np.random.default_rng(seed)
    idx, pts = _points(spec, rng, 20)
    pilot = _pilot(spec, rng)
    frame = np.asarray(jo.ofdm_modulate(spec, jnp.asarray(np.concatenate([pilot[None], pts]))))
    pre = np.asarray(jo.schmidl_cox_preamble(spec, jax.random.PRNGKey(seed)))
    sig = np.concatenate([np.zeros(277, np.complex64), pre, frame, np.zeros(64, np.complex64)])
    rx = np.convolve(sig, np.array([1.0, 0.3 - 0.1j, 0.1j]))[: sig.size]
    rx = rx * np.exp(2j * np.pi * 0.19 * np.arange(rx.size) / 64)
    p_sig = float(np.mean(np.abs(rx[277:-64]) ** 2))
    rx = rx + tsig.complex_awgn(rng, rx.shape, p_sig * 10 ** (-28 / 10))
    return idx, pilot, rx.astype(np.complex64)


@pytest.fixture(scope="module")
def ref():
    """The receivers' fixtures and JAX's run of each, once per module: the
    full OFDM receiver, the OFDM planes receiver per (order, n_pilot), and
    SC-FDE (complex tier per snr, planes)."""
    out = {}
    idx, pilot, rx = _rx_capture(6)
    out["rx"] = (idx, pilot, rx, jo.ofdm_rx(jo.make_ofdm_spec(), jnp.asarray(rx), 80,
                                             jnp.asarray(pilot)))
    out["planes"] = {}
    for order, n_pilot in PLANE_CASES:
        data, y, pilot, planes = _ofdm_planes_fixture(order, 24, n_pilot)
        fn = jax.jit(jop.make_ofdm_rx_planes(jo.make_ofdm_spec(64, 16, 52, order),
                                             n_pilot=n_pilot))
        jidx, (jzr, jzi) = fn(*map(jnp.asarray, planes))
        out["planes"][order, n_pilot] = (data, y, pilot, planes,
                                         tuple(np.array(v) for v in (jidx, jzr, jzi)))
    data, _, y = _scfde_fixture()
    jspec = jsc.make_scfde_spec(256, 32)
    rx = {snr: [tuple(np.array(v) for v in jsc.scfde_rx(jspec, jnp.asarray(y[ch]), snr=snr))
                for ch in range(C)] for snr in SCFDE_SNRS}
    planes = [np.ascontiguousarray(a, np.float32) for a in (y.real, y.imag)]
    jidx, (jzr, jzi) = jax.jit(jscp.make_scfde_rx_planes(jspec, order=4, snr=200.0))(
        *map(jnp.asarray, planes))
    out["scfde"] = (data, y, rx, planes, tuple(np.array(v) for v in (jidx, jzr, jzi)))
    return out


def test_ofdm_rx_equal_to_jax(ref):
    idx, pilot, rx, (jgot, jsoft, jinfo) = ref["rx"]
    spec = to.make_ofdm_spec()
    got, soft, info = to.ofdm_rx(spec, _t(rx), 80, _t(pilot))
    assert info["start"] == jinfo["start"] and abs(info["start"] - 277) <= 2
    assert abs(info["cfo"] - jinfo["cfo"]) <= 1e-5 and abs(info["cfo"] - 0.19) < 0.02
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))
    assert rel(soft.numpy(), jsoft) <= REL
    assert np.mean(got.numpy()[: idx.shape[0]] != idx) == 0.0


@pytest.mark.parametrize("cpe", [True, False])
def test_ofdm_demod_pieces_equal_to_jax(cpe):
    spec, jspec = to.make_ofdm_spec(), jo.make_ofdm_spec()
    rng = np.random.default_rng(2)
    idx, pts = _points(spec, rng, 10)
    pilot = _pilot(spec, rng)
    tx = np.asarray(jo.ofdm_modulate(jspec, jnp.asarray(np.concatenate([pilot[None], pts]))))
    rx = np.convolve(tx, np.array([1.0, 0.0, 0.4 - 0.2j, 0.0, -0.15j]))[: tx.size]
    rx = (rx * np.exp(2j * np.pi * 0.11 * np.arange(rx.size) / 64)).astype(np.complex64)
    eps = to.cfo_estimate_cp(_t(rx), spec)
    jeps = jo.cfo_estimate_cp(jnp.asarray(rx), jspec)
    assert abs(float(eps) - float(jeps)) <= 1e-5
    for e in (float(jeps), jnp.float32(jeps)):
        y = to.cfo_correct(_t(rx), e if isinstance(e, float) else torch.tensor(float(e)), 64)
        assert rel(y.numpy(), jo.cfo_correct(jnp.asarray(rx), e, 64)) <= REL
    y = np.asarray(jo.cfo_correct(jnp.asarray(rx), float(jeps), 64))
    f = to.ofdm_fft(spec, _t(y))
    assert rel(f.numpy(), jo.ofdm_fft(jspec, jnp.asarray(y))) <= REL
    h = to.ls_channel_estimate(f[0], _t(pilot))
    assert rel(h.numpy(), jo.ls_channel_estimate(jnp.asarray(f[0].numpy()),
                                                 jnp.asarray(pilot))) <= REL
    got, soft = to.ofdm_demod(spec, _t(y), _t(pilot), cpe=cpe)
    jgot, jsoft = jax.jit(lambda v: jo.ofdm_demod(jspec, v, jnp.asarray(pilot), cpe=cpe))(
        jnp.asarray(y))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))
    assert got.dtype == torch.int32 and rel(soft.numpy(), jsoft) <= REL
    np.testing.assert_array_equal(got.numpy(), idx)


def test_windowed_tx_frame_through_the_receiver():
    """The reference's WOLA fixture: `ofdm_tx_frame` (window 8, preamble
    from a Generator) after 171 zeros with a 0.08 CFO: the port's `ofdm_rx`
    finds the CFO and the transmitted symbols, as the reference's test asks
    of its own (`ofdm_rx` itself is held to JAX above)."""
    spec = to.make_ofdm_spec(128, 32, 56, 16)
    rng = np.random.default_rng(10)
    idx, pts = _points(spec, rng, 24)
    pilot = _pilot(spec, rng)
    frame = to.ofdm_tx_frame(spec, _t(pts), _t(pilot), np.random.default_rng(11), window=8)
    assert frame.shape == (25 * 160 + 160 + 8,) and frame.dtype == torch.complex64
    sig = np.concatenate([np.zeros(171, np.complex64), frame.numpy(), np.zeros(64, np.complex64)])
    rx = (sig * np.exp(2j * np.pi * 0.08 * np.arange(sig.size) / 128)).astype(np.complex64)
    got, _, info = to.ofdm_rx(spec, _t(rx), 160, _t(pilot))
    assert abs(info["start"] - 171) <= 2 and abs(info["cfo"] - 0.08) < 0.02
    np.testing.assert_array_equal(got.numpy()[: idx.shape[0]], idx)


def test_papr_equal_to_jax():
    spec, jspec = to.make_ofdm_spec(128, 32, 96, 16), jo.make_ofdm_spec(128, 32, 96, 16)
    _, pts = _points(spec, np.random.default_rng(12), 16)
    frame = np.asarray(jo.ofdm_modulate(jspec, jnp.asarray(pts)))
    for clip_db in (4.0, 5.5):
        got = to.papr_reduce(spec, _t(frame), clip_db=clip_db)
        want = jo.papr_reduce(jspec, jnp.asarray(frame), clip_db=clip_db)
        assert rel(got.numpy(), want) <= REL
        assert abs(float(to.papr_db(got)) - float(jo.papr_db(want))) <= 1e-4
    with pytest.raises(ValueError, match="whole"):
        to.papr_reduce(spec, _t(frame[:-1]))


# ---------- OFDM planes ----------

def _ofdm_planes_fixture(order, nsym, n_pilot, seed=0):
    spec = jo.make_ofdm_spec(64, 16, 52, order)
    rng = np.random.default_rng(seed)
    pts = np.asarray(qam_constellation(order))
    pilot = pts[rng.integers(0, order, 52)]
    data = rng.integers(0, order, (C, nsym, 52))
    y = []
    for ch in range(C):
        points = np.concatenate([np.tile(pilot[None], (n_pilot, 1)), pts[data[ch]]])
        tx = np.asarray(jo.ofdm_modulate(spec, jnp.asarray(points)))
        rx = np.convolve(tx, np.array([1.0, 0.25 * np.exp(0.7j)]))[: tx.size]
        rx = rx * np.exp(1j * (0.1 + 2e-5 * np.arange(rx.size) * (ch + 1)))
        rx = rx + 0.01 * (rng.standard_normal(rx.size) + 1j * rng.standard_normal(rx.size))
        y.append(rx.astype(np.complex64))
    y = np.stack(y)
    planes = [np.ascontiguousarray(a, np.float32) for a in (y.real, y.imag, pilot.real,
                                                            pilot.imag)]
    return data, y, pilot, planes


@pytest.mark.parametrize("order,n_pilot", PLANE_CASES)
def test_ofdm_rx_planes_equal_to_jax_and_complex_tier(ref, order, n_pilot):
    data, y, pilot, planes, (jidx, jzr, jzi) = ref["planes"][order, n_pilot]
    spec = to.make_ofdm_spec(64, 16, 52, order)
    idx, (zr, zi) = top.make_ofdm_rx_planes(spec, n_pilot=n_pilot, device="cpu")(
        *map(_t, planes))
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), jidx)
    assert rel(zr.numpy(), jzr) <= REL and rel(zi.numpy(), jzi) <= REL
    assert np.mean(idx.numpy() != data) == 0.0
    if n_pilot == 1:
        for ch in range(C):
            got, _ = to.ofdm_demod(spec, _t(y[ch]), _t(pilot))
            np.testing.assert_array_equal(got.numpy(), idx[ch].numpy())


# ---------- SC-FDE ----------

def _scfde_fixture(order=4, nblk=12, seed=0):
    spec = jsc.make_scfde_spec(256, 32)
    rng = np.random.default_rng(seed)
    pts = np.asarray(qam_constellation(order))
    data = rng.integers(0, order, (C, nblk, 256))
    y = []
    for ch in range(C):
        tx = np.asarray(jsc.scfde_tx(spec, jnp.asarray(pts[data[ch]])))
        rx = np.convolve(tx, np.array([1.0, 0.0, 0.45 * np.exp(1.1j)]))[: tx.size]
        rx = rx + 0.02 * (rng.standard_normal(rx.size) + 1j * rng.standard_normal(rx.size))
        y.append(rx.astype(np.complex64))
    return data, pts, np.stack(y)


def test_scfde_tx_bit_for_bit_and_spec():
    tspec = tsc.make_scfde_spec(256, 32, device="cpu")
    jspec = jsc.make_scfde_spec(256, 32)
    np.testing.assert_array_equal(tspec.pilot.numpy(), np.asarray(jspec.pilot))
    conv = convert.scfde_spec_from(jspec, device="cpu")
    assert (conv.n, conv.cp) == (256, 32) and torch.equal(conv.pilot, tspec.pilot)
    ospec = convert.ofdm_spec_from(jo.make_ofdm_spec(128, 32, 56, 64))
    assert ospec == to.make_ofdm_spec(128, 32, 56, 64)._replace(active=ospec.active)
    np.testing.assert_array_equal(ospec.active, to.make_ofdm_spec(128, 32, 56, 64).active)
    sym = np.asarray(qam_constellation(16))[np.random.default_rng(1).integers(0, 16, (3, 256))]
    got = tsc.scfde_tx(tspec, _t(sym))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jsc.scfde_tx(jspec, jnp.asarray(sym))))


@pytest.mark.parametrize("snr", SCFDE_SNRS)
def test_scfde_rx_equal_to_jax(ref, snr):
    data, y, rx, _, _ = ref["scfde"]
    tspec = tsc.make_scfde_spec(256, 32, device="cpu")
    for ch in range(C):
        eq, h = tsc.scfde_rx(tspec, _t(y[ch]), snr=snr)
        jeq, jh = rx[snr][ch]
        assert eq.dtype == torch.complex64
        assert rel(eq.numpy(), jeq) <= REL and rel(h.numpy(), jh) <= REL
        idx = qam_slice(eq, 4)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jqam_slice(jeq, 4)))
        np.testing.assert_array_equal(idx.numpy(), data[ch])


def test_scfde_rx_planes_equal_to_jax(ref):
    data, _, _, planes, (jidx, jzr, jzi) = ref["scfde"]
    idx, (zr, zi) = tscp.make_scfde_rx_planes(tsc.make_scfde_spec(device="cpu"), order=4,
                                              snr=200.0, device="cpu")(*map(_t, planes))
    np.testing.assert_array_equal(idx.numpy(), jidx)
    assert rel(zr.numpy(), jzr) <= REL and rel(zi.numpy(), jzi) <= REL
    np.testing.assert_array_equal(idx.numpy(), data)
