"""Port vs JAX package: the spread-spectrum chains, ``chains/dsss`` and
``chains/fhss``.

Fixtures (numpy, seeded), the reference tests' own
(``tests/unit/test_dsss.py``, ``test_fhss.py``): SF 63 BPSK at -8 dB chip
SNR with an unknown delay and carrier phase; a two-path channel (0.8 at 5
chips) at low SNR for the RAKE; QPSK spread and despread; Gold codes of
order 5 and 6; hops of 256 samples over 6 frequencies and a 12-hop pattern,
40 segments at offset 96 and sequence phase 7 in noise.

Contracts:

- bit-exact: m-sequences, Gold families, the shift matrix, the acquired
  code phase, the finger map's argmax order, BPSK and RAKE bits, the hop
  acquisition's (offset, phase);
- rel L2 <= 1e-5 (one pass): spread chips, despread symbols, the finger
  metric, the BPSK and RAKE soft outputs, the hopped and dehopped streams.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu.chains import dsss as jds
from srcdsp_tpu.chains import fhss as jfh
from srcdsp_tpu_torch import convert
from srcdsp_tpu_torch.chains import dsss as tds
from srcdsp_tpu_torch.chains import fhss as tfh
from tests.torch_threads import one_torch_thread  # noqa: F401

REL = 1e-5


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("taps,order", [((6, 1), 6), ((5, 2), 5), ((7, 3), 7),
                                        ((10, 3), 10)])
def test_msequence_equal(taps, order):
    np.testing.assert_array_equal(tds.pn_msequence(taps, order), jds.pn_msequence(taps, order))


@pytest.mark.parametrize("t1,t2,order", [([5, 2], [5, 4, 3, 2], 5), ([6, 1], [6, 5, 2, 1], 6)])
def test_gold_family_equal(t1, t2, order):
    np.testing.assert_array_equal(tds.gold_family(t1, t2, order), jds.gold_family(t1, t2, order))


def test_params_round_trip():
    jp = jds.make_dsss_params()
    tp = convert.dsss_params_from(jp, device="cpu")
    q = tds.make_dsss_params(device="cpu")
    assert tp.sf == q.sf == jp.sf == 63
    assert torch.equal(tp.chips, q.chips) and torch.equal(tp.shifts, q.shifts)
    np.testing.assert_array_equal(q.shifts.numpy(), np.asarray(jp.shifts))


def _bpsk_capture():
    jp = jds.make_dsss_params()
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2, 40).astype(np.int32)
    bits[0] = 0
    x = np.asarray(jds.dsss_spread(jp, jnp.asarray((1.0 - 2.0 * bits).astype(np.float32))))
    d = int(rng.integers(0, 63))
    n = x.size + 2 * 63
    y = np.zeros(n, np.complex64)
    y[d: d + x.size] = x * np.exp(1.1j)
    sigma = 10 ** (8 / 20) / np.sqrt(2)
    y += sigma * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return jp, bits, d, y.astype(np.complex64)


def test_acquire_and_bpsk_equal():
    jp, bits, d, y = _bpsk_capture()
    tp = tds.make_dsss_params(device="cpu")
    yt = torch.as_tensor(y)
    metric = tds.dsss_finger_search(tp, yt)
    assert rel(metric.numpy(), jds.dsss_finger_search(jp, jnp.asarray(y))) <= REL
    phase = tds.dsss_acquire(tp, yt)
    jphase = jds.dsss_acquire(jp, jnp.asarray(y))
    assert int(phase) == int(jphase) == (63 - d) % 63
    b, s = tds.dsss_demod_bpsk(tp, yt, phase)
    jb, js = jds.dsss_demod_bpsk(jp, jnp.asarray(y), jphase)
    assert b.dtype == torch.int32 and s.dtype == torch.float32
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    assert rel(s.numpy(), js) <= REL
    np.testing.assert_array_equal(b.numpy()[:40], bits)


@pytest.mark.parametrize("real", [True, False])
def test_spread_despread_equal(real):
    jp = jds.make_dsss_params()
    tp = tds.make_dsss_params(device="cpu")
    rng = np.random.default_rng(3)
    sym = (1.0 - 2.0 * rng.integers(0, 2, 9)).astype(np.float32) if real else \
        np.exp(1j * (np.pi / 4 + np.pi / 2 * rng.integers(0, 4, 9))).astype(np.complex64)
    x = tds.dsss_spread(tp, torch.as_tensor(sym))
    jx = np.asarray(jds.dsss_spread(jp, jnp.asarray(sym)))
    assert rel(x.numpy(), jx) <= REL
    xp = np.concatenate([jx, np.zeros(63, jx.dtype)])
    for ph in (0, 17):
        got = tds.dsss_despread(tp, torch.as_tensor(np.roll(xp, -ph)), (63 - ph) % 63)
        want = jds.dsss_despread(jp, jnp.asarray(np.roll(xp, -ph)), (63 - ph) % 63)
        assert rel(got.numpy(), want) <= REL


def test_rake_equal():
    jp = jds.make_dsss_params((6, 1), 6)
    tp = tds.make_dsss_params((6, 1), 6, device="cpu")
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, 400)
    bits[0] = 0
    tx = np.asarray(jds.dsss_spread(jp, jnp.asarray(1.0 - 2.0 * bits, jnp.float32)))
    x = tx.astype(np.complex64) + 0.8 * np.exp(1.1j) * np.concatenate([np.zeros(5), tx[:-5]])
    x = (x + 4.0 * (rng.standard_normal(x.size) + 1j * rng.standard_normal(x.size))
         ).astype(np.complex64)
    base = int(tds.dsss_acquire(tp, torch.as_tensor(x)))
    metric = tds.dsss_finger_search(tp, torch.as_tensor(x)).numpy()
    delays = sorted((base - int(t)) % 63 for t in np.argsort(metric)[::-1][:2])
    assert delays == [0, 5]
    br, sr = tds.dsss_rake_demod(tp, torch.as_tensor(x), base, delays=delays)
    jbr, jsr = jds.dsss_rake_demod(jp, jnp.asarray(x), base, delays=delays)
    np.testing.assert_array_equal(br.numpy(), np.asarray(jbr))
    assert rel(sr.numpy(), jsr) <= REL
    n = min(400, br.shape[0])
    assert int((br.numpy()[:n] != bits[:n]).sum()) <= 1


def _fh_params(mod):
    return mod.make_fhss_params(np.asarray([-0.35, -0.2, -0.05, 0.1, 0.25, 0.4]),
                                np.asarray([0, 3, 1, 5, 2, 4, 0, 5, 3, 2, 4, 1]), 256)


@pytest.mark.parametrize("n,phase", [(16 * 256, 5), (16 * 256 + 77, 0)])
def test_hop_dehop_equal(n, phase):
    jp, tp = _fh_params(jfh), _fh_params(tfh)
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    y = tfh.fhss_hop(tp, torch.as_tensor(x), seq_phase=phase)
    jy = np.asarray(jfh.fhss_hop(jp, jnp.asarray(x), seq_phase=phase))
    assert y.shape == (n,) and rel(y.numpy(), jy) <= REL
    z = tfh.fhss_dehop(tp, y, seq_phase=phase)
    assert rel(z.numpy(), jfh.fhss_dehop(jp, jnp.asarray(jy), seq_phase=phase)) <= REL
    assert rel(z.numpy(), x) <= REL


def test_acquire_equal():
    jp, tp = _fh_params(jfh), _fh_params(tfh)
    rng = np.random.default_rng(1)
    bb = (rng.standard_normal(40 * 256) / 4 + 1j * rng.standard_normal(40 * 256) / 4 + 1.0
          ).astype(np.complex64)
    y = np.asarray(jfh.fhss_hop(jp, jnp.asarray(bb), seq_phase=7))
    off = 3 * 256 // 8
    cap = np.concatenate([0.2 * (rng.standard_normal(off) + 1j * rng.standard_normal(off)), y])
    cap = (cap + 0.16 * (rng.standard_normal(cap.size) + 1j * rng.standard_normal(cap.size))
           ).astype(np.complex64)
    got = tfh.fhss_acquire(tp, cap, coarse=8, device="cpu")
    assert got == jfh.fhss_acquire(jp, jnp.asarray(cap), coarse=8)
    assert got[0] == off and got[1] == 7


def test_fhss_params_round_trip():
    jp = _fh_params(jfh)
    tp = convert.fhss_params_from(jp)
    np.testing.assert_array_equal(tp.freqs, jp.freqs)
    np.testing.assert_array_equal(tp.seq, jp.seq)
    assert tp.hop_len == jp.hop_len
