"""Port vs JAX package: convolutional encoder and Viterbi decoder (``fec``).

Contracts, bit for bit on the same numpy inputs:

- the code tables (K 3, 5, 7; rates 1/2 and 1/3) and `convert.conv_code_from`;
- `conv_encode`, terminated and open, batched;
- `viterbi_decode` on soft symbols (terminated and open), on integer-valued
  soft symbols (ties between the two candidates of a state on most steps:
  the first maximum wins, as the reference's argmax), and
  `viterbi_decode_hard`;
- punctured rates 2/3 and 3/4: `puncture`, `depuncture`, and the decode of
  the depunctured stream;
- `bpsk_soft` without noise is the +-1 map, with noise the generator's draw.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu import fec as jf
from srcdsp_tpu_torch import convert
from srcdsp_tpu_torch import fec as tf
from tests.torch_threads import one_torch_thread  # noqa: F401

CODES = {"k7": (7, (0o171, 0o133)), "k3": (3, (0o7, 0o5)), "k5r3": (5, (0o23, 0o35, 0o37))}
# the standard puncturing of the K=7 mother code (DVB-S / 802.11)
PUNCTURE = {"2/3": [1, 1, 0, 1], "3/4": [1, 1, 0, 1, 1, 0]}


@functools.cache
def _codes(name):
    k, gens = CODES[name]
    return jf.make_conv_code(k, gens), tf.make_conv_code(k, gens)


@functools.cache
def _jax_viterbi(name, terminated):
    """The reference decoder, jitted (its eager scan is slow)."""
    jc = _codes(name)[0]
    return jax.jit(lambda s: jf.viterbi_decode(jc, s, terminated=terminated))


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", sorted(CODES))
def test_tables_equal(name):
    jc, tc = _codes(name)
    conv = convert.conv_code_from(jc)
    for f in jc._fields:
        np.testing.assert_array_equal(np.asarray(getattr(tc, f)), np.asarray(getattr(jc, f)), f)
        np.testing.assert_array_equal(np.asarray(getattr(conv, f)), np.asarray(getattr(jc, f)), f)


@pytest.mark.parametrize("name", sorted(CODES))
@pytest.mark.parametrize("terminate", [True, False])
def test_encode_equal(name, terminate):
    jc, tc = _codes(name)
    u = np.random.default_rng(1).integers(0, 2, (3, 2, 50))
    got = tf.conv_encode(tc, torch.as_tensor(u), terminate=terminate)
    assert got.dtype == torch.int32
    _eq(got, jf.conv_encode(jc, jnp.asarray(u), terminate=terminate))


def _soft(jc, t, sigma, seed, terminate=True, batch=6):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, (batch, t))
    cw = np.array(jf.conv_encode(jc, jnp.asarray(u), terminate=terminate))
    return u, cw, ((1.0 - 2.0 * cw) + sigma * rng.standard_normal(cw.shape)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(CODES))
@pytest.mark.parametrize("terminated", [True, False])
def test_viterbi_soft_equal(name, terminated):
    jc, tc = _codes(name)
    _, _, soft = _soft(jc, 80, 0.8, 3, terminated)
    got = tf.viterbi_decode(tc, torch.as_tensor(soft), terminated=terminated)
    _eq(got, _jax_viterbi(name, terminated)(jnp.asarray(soft)))


@pytest.mark.parametrize("name", ["k7", "k3"])
@pytest.mark.parametrize("terminated", [True, False])
def test_viterbi_ties_and_hard_equal(name, terminated):
    """Integer soft values and hard bits tie the two candidates of a state on
    most steps."""
    jc, tc = _codes(name)
    _, _, soft = _soft(jc, 64, 1.2, 4, terminated)
    soft_i = np.round(soft).astype(np.float32)
    _eq(tf.viterbi_decode(tc, torch.as_tensor(soft_i), terminated=terminated),
        _jax_viterbi(name, terminated)(jnp.asarray(soft_i)))
    hard = (soft < 0).astype(np.int32)
    _eq(tf.viterbi_decode_hard(tc, torch.as_tensor(hard), terminated=terminated),
        jf.viterbi_decode_hard(jc, jnp.asarray(hard), terminated=terminated))


@pytest.mark.parametrize("rate", sorted(PUNCTURE))
def test_punctured_equal(rate):
    pat = PUNCTURE[rate]
    jc, tc = _codes("k7")
    # 72 info bits + 6 tail: 156 coded bits, whole periods of 4 and 6
    u, cw, _ = _soft(jc, 72, 0.0, 5)
    sent = tf.puncture(torch.as_tensor(cw), pat)
    _eq(sent, jf.puncture(jnp.asarray(cw), pat))
    rx = ((1.0 - 2.0 * sent.numpy()) + 0.5 * np.random.default_rng(6).standard_normal(
        sent.shape)).astype(np.float32)
    full = tf.depuncture(torch.as_tensor(rx), pat)
    _eq(full, jf.depuncture(jnp.asarray(rx), pat))
    dec = tf.viterbi_decode(tc, full)
    _eq(dec, _jax_viterbi("k7", True)(jnp.asarray(full.numpy())))
    assert float((dec.numpy() != u).mean()) < 0.02
    with pytest.raises(ValueError, match="periods"):
        tf.puncture(torch.as_tensor(cw[:, 1:]), pat)


def test_bpsk_soft_and_errors():
    bits = torch.as_tensor(np.random.default_rng(0).integers(0, 2, (2, 40)))
    s = tf.bpsk_soft(bits)
    _eq(s, jf.bpsk_soft(jnp.asarray(bits.numpy())))
    gen = torch.Generator().manual_seed(1)
    noisy = tf.bpsk_soft(bits, gen, noise_std=0.5)
    want = s + 0.5 * torch.randn(s.shape, generator=torch.Generator().manual_seed(1))
    assert torch.equal(noisy, want)
    jc, tc = _codes("k7")
    with pytest.raises(ValueError, match="multiple"):
        tf.viterbi_decode(tc, torch.zeros(3, 11))
    with pytest.raises(ValueError, match="tail"):
        tf.viterbi_decode(tc, torch.zeros(3, 12))
    with pytest.raises(ValueError, match="constraint"):
        tf.make_conv_code(1, (1,))
