"""Port vs JAX package: GMSK/MSK coherent demodulation and pi/4-DQPSK,
``chains/msk``, ``testing.signals.gmsk_baseband`` and ``chains/dqpsk``.

Fixtures (numpy, seeded), the reference tests' parameters: GMSK BT 0.3 and
MSK at sps 8 over 600 bits at ~8 dB (``tests/unit/test_msk.py``); DQPSK at
decim 4, sps 8, center 0.11 over 2 channels x 256 dibits, one clean, one
with a 0.0005 CFO and noise, streamed in 8 blocks
(``tests/unit/test_dqpsk.py``). JAX runs each once per module (jitted).

Contracts:

- bit-exact: `gmsk_baseband`, `laurent_c0`, `pseudo_symbols`,
  `dqpsk_baseband` (host numpy on both sides), the MSK bits, the DQPSK
  dibits, the slicer on exact and perturbed angles;
- rel L2 <= 1e-5: the MSK soft metric (one pass); the DQPSK conjugate
  products and every carried state field within 1e-5 of its magnitude
  (the O&M timing accumulator is a recursion over blocks; measured
  <= 6.6e-7 on these fixtures);
- a JAX DQPSK state handed to the port after block 3 gives JAX's blocks
  4-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu.chains import dqpsk as jdq
from srcdsp_tpu.chains import msk as jmsk
from srcdsp_tpu.testing import signals as jsig
from srcdsp_tpu_torch import convert
from srcdsp_tpu_torch.chains import dqpsk as tdq
from srcdsp_tpu_torch.chains import msk as tmsk
from srcdsp_tpu_torch.testing import signals as tsig
from tests.torch_threads import one_torch_thread  # noqa: F401

REL = 1e-5
DECIM, SPS, CENTER, NDIB, BLOCKS = 4, 8, 0.11, 256, 8


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _leaves(s):
    return [x for v in s for x in _leaves(v)] if isinstance(s, tuple) else [s]


@pytest.mark.parametrize("bt", [None, 0.3, 0.5])
def test_gmsk_baseband_equal(bt):
    bits = np.random.default_rng(1).integers(0, 2, (2, 200))
    np.testing.assert_array_equal(tsig.gmsk_baseband(bits, 8, bt=bt),
                                  jsig.gmsk_baseband(bits, 8, bt=bt))


@pytest.mark.parametrize("bt,c_span", [(None, 2), (0.3, 4)])
def test_laurent_pulse_equal(bt, c_span):
    np.testing.assert_array_equal(tmsk.laurent_c0(8, bt=bt, c_span=c_span, nsym=256),
                                  jmsk.laurent_c0(8, bt=bt, c_span=c_span, nsym=256))
    bits = np.random.default_rng(2).integers(0, 2, 64)
    np.testing.assert_array_equal(tmsk.pseudo_symbols(bits), jmsk.pseudo_symbols(bits))


@pytest.mark.parametrize("bt,c_span", [(None, 2), (0.3, 4)])
def test_msk_coherent_demod_equal(bt, c_span):
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, 600)
    x = tsig.gmsk_baseband(bits, SPS, bt=bt).astype(np.complex128)
    sigma = np.sqrt(1.0 / (2 * SPS * 10 ** 0.8))
    x = (x + sigma * (rng.standard_normal(x.size) + 1j * rng.standard_normal(x.size))
         ).astype(np.complex64)
    c0 = jmsk.laurent_c0(SPS, bt=bt, c_span=c_span)
    jb, js = jmsk.msk_coherent_demod(jnp.asarray(x), SPS, c0)
    tb, ts = tmsk.msk_coherent_demod(torch.as_tensor(x), SPS, c0)
    assert tb.dtype == torch.int32 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert rel(ts.numpy(), js) <= REL
    assert np.mean(tb.numpy()[8:] != bits[1:tb.shape[0] + 1][8:]) < 0.02


def _captures():
    rng = np.random.default_rng(0)
    dib = rng.integers(0, 4, (2, NDIB))
    bb = tdq.dqpsk_baseband(dib, DECIM * SPS)
    n = bb.shape[-1]
    k = np.arange(n)
    x = bb * np.exp(2j * np.pi * np.stack([CENTER * k, (CENTER + 0.0005) * k]))
    x[1] += 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    n8 = (n // (DECIM * SPS * BLOCKS)) * (DECIM * SPS * BLOCKS)
    return dib, x[:, :n8].astype(np.complex64)


@pytest.fixture(scope="module")
def dq():
    dib, x = _captures()
    jp = jdq.make_dqpsk_params(CENTER, DECIM, SPS)
    step = jax.jit(lambda s, v: jdq.dqpsk_apply(jp, s, v))
    blk = x.shape[-1] // BLOCKS
    st, states, outs = jdq.dqpsk_init(jp, (2,)), [], []
    for b in range(BLOCKS):
        st, o = step(st, jnp.asarray(x[:, b * blk:(b + 1) * blk]))
        states.append(st)
        outs.append([np.asarray(v) for v in o])
    return dict(dib=dib, x=x, blk=blk, states=states, outs=outs, jp=jp)


def test_dqpsk_baseband_equal():
    dib = np.random.default_rng(4).integers(0, 4, (2, 40))
    np.testing.assert_array_equal(tdq.dqpsk_baseband(dib, 16), jdq.dqpsk_baseband(dib, 16))


def test_dqpsk_slice_equal():
    ang = np.concatenate([(2 * np.arange(4) + 1) * np.pi / 4,
                          np.linspace(-3.1, 3.1, 97)])
    z = np.exp(1j * ang).astype(np.complex64)
    got = tdq.dqpsk_slice(torch.as_tensor(z))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jdq.dqpsk_slice(jnp.asarray(z))))
    np.testing.assert_array_equal(got.numpy()[:4], np.arange(4))


def _run(x, blk, state=None, start=0):
    p = tdq.make_dqpsk_params(CENTER, DECIM, SPS, device="cpu")
    st = tdq.dqpsk_init(p, (2,)) if state is None else state
    outs = []
    for b in range(start, BLOCKS):
        st, o = tdq.dqpsk_apply(p, st, torch.as_tensor(x[:, b * blk:(b + 1) * blk]))
        outs.append(o)
    return st, outs


def _check(outs, jouts, st, jst):
    for (ti, tz), (ji, jz) in zip(outs, jouts):
        assert ti.dtype == torch.int32 and tz.dtype == torch.complex64
        np.testing.assert_array_equal(ti.numpy(), ji)
        assert rel(tz.numpy(), jz) <= REL
    for p, r in zip(_leaves(st), _leaves(jst)):
        r = np.asarray(r)
        if r.dtype == np.uint32:
            np.testing.assert_array_equal(p.numpy(), r.astype(np.int64))
        else:
            scale = max(1.0, float(np.max(np.abs(r))))
            np.testing.assert_allclose(p.numpy(), r, rtol=0, atol=REL * scale)


def test_dqpsk_stream_equal_and_decodes(dq):
    st, outs = _run(dq["x"], dq["blk"])
    _check(outs, dq["outs"], st, dq["states"][-1])
    idx = torch.cat([o[0] for o in outs], dim=-1).numpy()
    for ch in range(2):      # SER 0 past the first (reference) symbol, best lag
        tx, rx = dq["dib"][ch, 1:], idx[ch, 1:]
        best = min(np.mean(tx[:min(tx.size, rx.size - lag)] != rx[lag:lag + tx.size])
                   for lag in range(24))
        assert best == 0.0


def test_dqpsk_jax_state_handoff(dq):
    st = convert.dqpsk_state_from(dq["states"][3], device="cpu")
    st, outs = _run(dq["x"], dq["blk"], state=st, start=4)
    _check(outs, dq["outs"][4:], st, dq["states"][-1])


def test_dqpsk_demod_stream_equal(dq):
    p = tdq.make_dqpsk_params(CENTER, DECIM, SPS, device="cpu")
    idx, z = tdq.dqpsk_demod_stream(p, torch.as_tensor(dq["x"]), dq["blk"], (2,))
    np.testing.assert_array_equal(idx.numpy(), np.concatenate([o[0] for o in dq["outs"]], -1))
    assert rel(z.numpy(), np.concatenate([o[1] for o in dq["outs"]], -1)) <= REL
