"""Port vs JAX package: Reed-Solomon (``rs``) and binary BCH (``bch``).

Contracts, bit for bit on the same numpy inputs:

- every table (`make_rs_code`, `make_bch_code`, and `convert.rs_code_from`
  / `bch_code_from` of the JAX codes);
- encode, then decode at every error count 0..t and beyond t: messages and
  `ok` flags equal (beyond t both packages flag the same words, and may
  miscorrect the same way);
- RS shortened to n < 255; BCH with `shorten=`, its prefix check included.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu import bch as jb
from srcdsp_tpu import rs as jr
from srcdsp_tpu_torch import bch as tb
from srcdsp_tpu_torch import convert
from srcdsp_tpu_torch import rs as tr
from tests.torch_threads import one_torch_thread  # noqa: F401


@functools.cache
def _rs(n, k):
    jc = jr.make_rs_code(n, k)
    dec = functools.partial(jr.rs_decode, jc)
    # at t 16, jitting the reference's unrolled Omega and Forney takes longer
    # than one eager call
    return jc, tr.make_rs_code(n, k, device="cpu"), dec if jc.t > 8 else jax.jit(dec)


@functools.cache
def _bch(m, t, shorten):
    jc = jb.make_bch_code(m, t)
    return jc, tb.make_bch_code(m, t, device="cpu"), jax.jit(
        lambda r: jb.bch_decode(jc, r, shorten=shorten))


def _tables_equal(jc, tc):
    for f in jc._fields:
        np.testing.assert_array_equal(np.asarray(getattr(tc, f)), np.asarray(getattr(jc, f)), f)


@pytest.mark.parametrize("n,k", [(255, 223), (63, 47), (15, 11)])
def test_rs_tables_equal(n, k):
    jc, tc, _ = _rs(n, k)
    _tables_equal(jc, tc)
    conv = convert.rs_code_from(jc, device="cpu")
    _tables_equal(jc, conv)
    assert conv.enc_bits.dtype == torch.float32 and conv.exp.dtype == torch.int64


def _corrupt(cw, counts, rng, flip):
    recv = cw.copy()
    for row, ne in zip(recv, counts):
        row[rng.choice(row.size, ne, replace=False)] ^= flip(ne)
    return recv


@pytest.mark.parametrize("n,k", [(255, 223), (40, 30), (31, 27)])
def test_rs_encode_decode_equal(n, k):
    jc, tc, jdec = _rs(n, k)
    rng = np.random.default_rng(n)
    counts = [e % (jc.t + 5) for e in range(3 * (jc.t + 5))]    # 0..t+4 errors
    msg = rng.integers(0, 256, (len(counts), k), dtype=np.uint8)
    cw = tr.rs_encode(tc, torch.as_tensor(msg))
    np.testing.assert_array_equal(cw.numpy(), np.asarray(jr.rs_encode(jc, jnp.asarray(msg))))
    recv = _corrupt(cw.numpy(), counts, rng,
                    lambda ne: rng.integers(1, 256, ne).astype(np.uint8))
    got, ok = tr.rs_decode(tc, torch.as_tensor(recv))
    want, jok = jdec(jnp.asarray(recv))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    small = np.asarray(counts) <= jc.t
    assert ok.numpy()[small].all()
    np.testing.assert_array_equal(got.numpy()[small], msg[small])
    assert not ok.numpy()[~small].all()


@pytest.mark.parametrize("m,t", [(5, 2), (6, 3), (8, 2)])
def test_bch_tables_equal(m, t):
    jc, tc, _ = _bch(m, t, 0)
    _tables_equal(jc, tc)
    assert isinstance(tc.gen, np.ndarray)
    _tables_equal(jc, convert.bch_code_from(jc, device="cpu"))


@pytest.mark.parametrize("m,t,shorten", [(5, 2, 0), (6, 3, 0), (8, 2, 0), (5, 2, 6), (6, 3, 20)])
def test_bch_encode_decode_equal(m, t, shorten):
    jc, tc, jdec = _bch(m, t, shorten)
    rng = np.random.default_rng(m * 10 + shorten)
    counts = [e % (t + 4) for e in range(8 * (t + 4))]          # 0..t+3 errors
    msg = rng.integers(0, 2, (len(counts), jc.k - shorten))
    cw = tb.bch_encode(tc, torch.as_tensor(msg), shorten=shorten)
    np.testing.assert_array_equal(
        cw.numpy(), np.asarray(jb.bch_encode(jc, jnp.asarray(msg), shorten=shorten)))
    recv = _corrupt(cw.numpy(), counts, rng, lambda ne: 1)
    got, ok = tb.bch_decode(tc, torch.as_tensor(recv), shorten=shorten)
    want, jok = jdec(jnp.asarray(recv))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    small = np.asarray(counts) <= t
    assert ok.numpy()[small].all()
    np.testing.assert_array_equal(got.numpy()[small], msg[small])


def test_refusals():
    with pytest.raises(ValueError, match="n-k even"):
        tr.make_rs_code(255, 224, device="cpu")
    with pytest.raises(ValueError, match="too large"):
        tb.make_bch_code(3, 4, device="cpu")
    tc = tb.make_bch_code(5, 2, device="cpu")
    with pytest.raises(ValueError, match="shorten"):
        tb.bch_encode(tc, torch.zeros(2, 1), shorten=21)
