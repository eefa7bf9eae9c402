"""Port vs JAX package: polar codes (``polar``).

Contracts, bit for bit on the same numpy inputs (decisions, codewords and
path metrics):

- `make_polar` (frozen set, data positions) and `convert.polar_code_from`;
- `polar_encode`, batched;
- SC `polar_decode` at N 16 and 64;
- SCL `polar_decode_list` at L 1/2/4/8 (N 16), L 8 (N 32), L 4 (N 64):
  info, u_hat and path metrics; the reference sorts with a stable argsort
  and its path metrics tie at the start, so an unstable sort would differ;
- `polar_decode_list_onehot` with and without `fast` against the reference's
  one-hot form, and against the port's gather form at N up to 128.

The reference's SCL is unrolled at trace time and compiles slowly, so its
cases stay at N <= 64.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu import polar as jp
from srcdsp_tpu_torch import convert
from srcdsp_tpu_torch import polar as tp
from tests.torch_threads import one_torch_thread  # noqa: F401


@functools.cache
def _codes(n):
    return jp.make_polar(n, n // 2), tp.make_polar(n, n // 2)


def _llrs(n, seed, batch=12, snr_db=1.0):
    """LLRs of random codewords through BPSK + AWGN (numpy)."""
    jc, tc = _codes(n)
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, (batch, jc.k))
    cw = tp.polar_encode(tc, torch.as_tensor(u)).numpy()
    sigma = 10.0 ** (-snr_db / 20.0)
    y = (1.0 - 2.0 * cw) + sigma * rng.standard_normal(cw.shape)
    return u, cw, (2.0 / sigma ** 2 * y).astype(np.float32)


def _eq_all(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n,k", [(8, 4), (64, 20), (256, 128), (1024, 512), (32, 31)])
def test_make_polar_equal(n, k):
    jc, tc = jp.make_polar(n, k), tp.make_polar(n, k)
    np.testing.assert_array_equal(tc.frozen, jc.frozen)
    np.testing.assert_array_equal(tc.data_pos, jc.data_pos)
    conv = convert.polar_code_from(jc)
    np.testing.assert_array_equal(conv.frozen, jc.frozen)
    np.testing.assert_array_equal(conv.data_pos, jc.data_pos)
    with pytest.raises(ValueError, match="power of two"):
        tp.make_polar(n + 1, k)


@pytest.mark.parametrize("n", [16, 256])
def test_encode_equal(n):
    jc, tc = _codes(n)
    u = np.random.default_rng(n).integers(0, 2, (2, 3, jc.k))
    got = tp.polar_encode(tc, torch.as_tensor(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jp.polar_encode(jc, jnp.asarray(u))))


@pytest.mark.parametrize("n", [16, 64])
def test_sc_equal(n):
    jc, tc = _codes(n)
    u, _, llr = _llrs(n, 1)
    want = jax.jit(jax.vmap(lambda l: jp.polar_decode(jc, l)))(jnp.asarray(llr))
    got = tp.polar_decode(tc, torch.as_tensor(llr))
    _eq_all(got, want)
    assert float((got[0].numpy() != u).mean()) < 0.2


@pytest.mark.parametrize("n,lsz", [(16, 1), (16, 2), (16, 4), (16, 8), (32, 8), (64, 4)])
def test_scl_equal(n, lsz):
    jc, tc = _codes(n)
    _, _, llr = _llrs(n, lsz)
    want = jax.jit(jax.vmap(lambda l: jp.polar_decode_list(jc, l, lsz)))(jnp.asarray(llr))
    got = tp.polar_decode_list(tc, torch.as_tensor(llr), lsz)
    assert got[0].shape == (12, lsz, jc.k) and got[2].dtype == torch.float32
    _eq_all(got, want)


@pytest.mark.parametrize("n,lsz,fast", [(16, 8, False), (32, 8, True)])
def test_scl_onehot_equal(n, lsz, fast):
    jc, tc = _codes(n)
    _, _, llr = _llrs(n, 7)
    want = jax.jit(jax.vmap(lambda l: jp.polar_decode_list_onehot(jc, l, lsz, fast=fast)))(
        jnp.asarray(llr))
    _eq_all(tp.polar_decode_list_onehot(tc, torch.as_tensor(llr), lsz, fast=fast), want)


@pytest.mark.parametrize("n,lsz", [(16, 2), (64, 8), (128, 4), (128, 8)])
def test_scl_onehot_equals_gather_form(n, lsz):
    _, tc = _codes(n)
    _, _, llr = _llrs(n, n + lsz, batch=16, snr_db=0.0)
    x = torch.as_tensor(llr)
    gather = tp.polar_decode_list(tc, x, lsz)
    for fast in (False, True):
        for g, o in zip(gather, tp.polar_decode_list_onehot(tc, x, lsz, fast=fast)):
            assert torch.equal(g, o)
    with pytest.raises(ValueError, match="list_size"):
        tp.polar_decode_list(tc, x, 0)
