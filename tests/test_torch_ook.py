"""Port vs JAX package: the OOK/ASK chain, ``chains/ook``.

Fixtures (numpy, seeded), the reference's own (``tests/unit/test_ook.py``)
at 2 channels and sps 8: clean OOK with a carrier rotation, edge-filtered
OOK (rise 3) with a 0.003 CFO at ~17 dB, and 50 %-depth ASK, each 512 bits
streamed in 4 blocks. JAX (jitted) runs each once per module.

Contracts:

- bits equal to JAX's, BER 0 (clean, ASK) and < 0.005 (noisy) after a
  best-lag search, as the reference asks;
- strobes within rel L2 1e-4 and each field of the carried state within
  1e-4 absolute, scaled by the field's largest magnitude where that
  exceeds 1: the timing-tone accumulator and the cluster sums run in the
  hundreds to thousands, where one float32 ulp is 6e-5 to 2.4e-4 (the
  accumulator sums a whole block in an order XLA and torch choose
  differently). Measured here: strobes <= 1.4e-5, the accumulator within
  1.7e-6 of its magnitude;
- a JAX state handed to the port after block 1 gives JAX's blocks 2-3;
- `manchester_decode` bit for bit (both alignments, odd lengths);
- `ook_demod_full` equal to one `ook_apply` from rest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu.chains import ook as jook
from srcdsp_tpu_torch import convert
from srcdsp_tpu_torch.chains import ook as took
from srcdsp_tpu_torch.testing.signals import complex_awgn, manchester_encode, ook_baseband
from tests.torch_threads import one_torch_thread  # noqa: F401

C, SPS, NBITS, BLOCKS = 2, 8, 512, 4
REL, ABS = 1e-4, 1e-4


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _leaves(s):
    return [x for v in s for x in _leaves(v)] if isinstance(s, tuple) else [s]


def _fixtures():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (3, C, NBITS))
    n = NBITS * SPS
    clean = ook_baseband(bits[0], SPS) * np.complex64(np.exp(0.7j))
    cfo = np.exp(2j * np.pi * 0.003 * np.arange(n)).astype(np.complex64)
    noisy = ook_baseband(bits[1], SPS, rise=3) * cfo + complex_awgn(rng, (C, n), 0.01)
    ask = ook_baseband(bits[2], SPS, depth=0.5) + complex_awgn(rng, (C, n), 1e-4)
    return {"clean": (bits[0], clean.astype(np.complex64), 0.0),
            "noisy": (bits[1], noisy.astype(np.complex64), 0.005),
            "ask": (bits[2], ask.astype(np.complex64), 0.0)}


def _best_ber(tx, rx, max_lag=4):
    best = 1.0
    for lag in range(max_lag + 1):
        n = min(len(tx), len(rx)) - lag
        best = min(best, float(np.mean(tx[:n] != rx[lag:lag + n])),
                   float(np.mean(tx[lag:lag + n] != rx[:n])))
    return best


@pytest.fixture(scope="module")
def ref():
    fix = _fixtures()
    jpar = jook.make_ook_params(SPS)
    step = jax.jit(lambda s, v: jook.ook_apply(jpar, s, v))
    out = {"fix": fix}
    blk = NBITS * SPS // BLOCKS
    for name, (_, x, _) in fix.items():
        st, states, outs = jook.ook_init(jpar, (C,)), [], []
        for b in range(BLOCKS):
            st, o = step(st, jnp.asarray(x[:, b * blk:(b + 1) * blk]))
            states.append(st)
            outs.append([np.asarray(v) for v in o])
        out[name] = (states, outs)
    return out


def _run_port(x, state=None, start=0):
    par = took.make_ook_params(SPS)
    st = took.ook_init(par, (C,), device="cpu") if state is None else state
    blk = NBITS * SPS // BLOCKS
    outs = []
    for b in range(start, BLOCKS):
        st, o = took.ook_apply(par, st, torch.from_numpy(x[:, b * blk:(b + 1) * blk]))
        outs.append(o)
    return st, outs


def _check(outs, jouts, st, jst):
    for (tb, ts), (jb, js) in zip(outs, jouts):
        assert tb.dtype == torch.int32 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tb.numpy(), jb)
        assert rel(ts.numpy(), js) <= REL
    for p, r in zip(_leaves(st), _leaves(jst)):
        r = np.asarray(r)
        assert tuple(p.shape) == r.shape
        scale = max(1.0, float(np.max(np.abs(r))))
        np.testing.assert_allclose(p.numpy(), r, rtol=0, atol=ABS * scale)


@pytest.mark.parametrize("name", ["clean", "noisy", "ask"])
def test_ook_stream_equal_to_jax_and_decodes(ref, name):
    bits, x, max_ber = ref["fix"][name]
    states, jouts = ref[name]
    st, outs = _run_port(x)
    _check(outs, jouts, st, states[-1])
    rx = torch.cat([o[0] for o in outs], dim=-1).numpy()
    for ch in range(C):
        assert _best_ber(bits[ch], rx[ch]) <= max_ber


@pytest.mark.parametrize("name", ["clean", "noisy"])
def test_jax_state_handed_over_mid_stream(ref, name):
    _, x, _ = ref["fix"][name]
    states, jouts = ref[name]
    st, outs = _run_port(x, state=convert.ook_state_from(states[1], device="cpu"), start=2)
    _check(outs, jouts[2:], st, states[-1])


def test_ook_demod_full_equals_one_apply():
    _, x, _ = _fixtures()["noisy"]
    par = took.make_ook_params(SPS)
    bits, strobes = took.ook_demod_full(par, torch.from_numpy(x))
    _, (b1, s1) = took.ook_apply(par, took.ook_init(par, (C,), device="cpu"), torch.from_numpy(x))
    assert torch.equal(bits, b1) and torch.equal(strobes, s1)
    jb, js = jax.jit(lambda v: jook.ook_demod_full(jook.make_ook_params(SPS), v))(jnp.asarray(x))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jb))
    assert rel(strobes.numpy(), js) <= REL


@pytest.mark.parametrize("length,shift", [(64, 0), (64, 1), (65, 0), (65, 1), (3, 0), (7, 1)])
def test_manchester_decode_bit_for_bit(length, shift):
    rng = np.random.default_rng(length + shift)
    chips = manchester_encode(rng.integers(0, 2, (C, length)))[:, shift: shift + length]
    chips[0, ::7] ^= 1                                   # some invalid pairs
    tb, tv = took.manchester_decode(torch.from_numpy(chips))
    jb, jv = jook.manchester_decode(jnp.asarray(chips))
    assert tb.dtype == torch.int32 and tv.dtype == torch.float32
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_manchester_through_ook():
    """Line-coded bits -> OOK chips -> port chain -> decode: BER 0."""
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, (C, 256))
    x = ook_baseband(manchester_encode(bits), SPS)
    chips, _ = took.ook_demod_full(took.make_ook_params(SPS), torch.from_numpy(x))
    for ch in range(C):
        best = 1.0
        for lag in range(6):
            dec, _ = took.manchester_decode(chips[ch, lag:])
            n = min(dec.shape[-1], bits.shape[-1]) - 8
            for k in range(3):
                best = min(best, float(np.mean(dec.numpy()[k:k + n] != bits[ch, :n])))
        assert best == 0.0


def test_params_and_init_match_jax():
    with pytest.raises(ValueError, match="sps"):
        took.make_ook_params(1)
    with pytest.raises(ValueError, match="forget"):
        took.make_ook_params(8, timing_forget=1.0)
    with pytest.raises(ValueError, match="3 chips"):
        took.manchester_decode(torch.zeros(2, dtype=torch.int32))
    assert tuple(took.make_ook_params(8, 0.3, 0.7)) == tuple(jook.make_ook_params(8, 0.3, 0.7))
    ts = took.ook_init(took.make_ook_params(SPS), (C,), device="cpu")
    js = jook.ook_init(jook.make_ook_params(SPS), (C,))
    for p, r in zip(_leaves(ts), _leaves(js)):
        assert p.dtype == {np.dtype(np.float32): torch.float32,
                           np.dtype(np.complex64): torch.complex64}[np.asarray(r).dtype]
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))
