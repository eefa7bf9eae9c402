"""Port vs JAX package: ``ops/farrow`` (cubic-Lagrange arbitrary-ratio
resampler) on the same numpy inputs, at the JAX unit tests' shapes.

Contracts: the validity masks are equal (the int32 phase arithmetic, with
floor division and a floor remainder on phases that go negative, is exact);
the valid lanes agree within 1e-6 (float32 Lagrange sums in another order),
and within 2e-6 of the double-precision twin `np_farrow`, the reference's
own bound; block streaming equals one shot bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu.ops import farrow as jf
from srcdsp_tpu_torch import convert
from srcdsp_tpu_torch.ops import farrow as tf
from tests.torch_threads import one_torch_thread  # noqa: F401


def _noise(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _blocks(x, l_out, m_in, nblocks, port=True, state=None):
    """(ys, valids) per block, from `state` (rest by default)."""
    ch = x.shape[:-1]
    if port:
        st = state or tf.farrow_init(ch, device="cpu")
        run = lambda s, b: tf.farrow_apply(s, torch.from_numpy(b), l_out, m_in)  # noqa: E731
    else:
        st = state or jf.farrow_init(ch)
        run = lambda s, b: jf.farrow_apply(s, jnp.asarray(b), l_out, m_in)  # noqa: E731
    out = []
    for blk in np.split(x, nblocks, axis=-1):
        st, (y, v) = run(st, blk)
        out.append((np.asarray(y), np.asarray(v)))
    return st, out


@pytest.mark.parametrize("l_out,m_in", [(160, 147), (147, 160), (1, 3), (3, 1), (1000, 997)])
def test_matches_jax_and_twin(l_out, m_in):
    x = _noise(2048, seed=0)
    (_, [(got, gv)]), (_, [(ref, rv)]) = (_blocks(x, l_out, m_in, 1),
                                          _blocks(x, l_out, m_in, 1, port=False))
    assert gv.dtype == bool and np.array_equal(gv, rv)
    np.testing.assert_allclose(got[gv], ref[rv], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[gv], tf.np_farrow(x, l_out, m_in), rtol=0, atol=2e-6)


def test_streaming_bit_exact_and_negative_phase_masks_equal_jax():
    """8 blocks of 160/147: the carried phase goes negative between blocks;
    the per-block masks equal JAX's, the joined outputs equal one shot."""
    x = _noise(4096, seed=1)
    (_, one), = [_blocks(x, 160, 147, 1)]
    pst, many = _blocks(x, 160, 147, 8)
    jst, jmany = _blocks(x, 160, 147, 8, port=False)
    for (g, gv), (r, rv) in zip(many, jmany):
        assert np.array_equal(gv, rv)
        np.testing.assert_allclose(g[gv], r[rv], rtol=0, atol=1e-6)
    assert int(pst.p) == int(np.asarray(jst.p)) and pst.p.dtype == torch.int32
    joined = np.concatenate([y[v] for y, v in many])
    assert np.array_equal(joined, one[0][0][one[0][1]])


def test_jax_stream_carried_on_in_the_port():
    x = _noise((3, 1024), seed=2)
    _, ref = _blocks(x, 8, 5, 4, port=False)
    jst, first = _blocks(x[:, :512], 8, 5, 2, port=False)
    _, rest = _blocks(x[:, 512:], 8, 5, 2, state=convert.farrow_state_from(jst, device="cpu"))
    for (g, gv), (r, rv) in zip(first + rest, ref):
        assert np.array_equal(gv, rv)
        np.testing.assert_allclose(g[..., gv], r[..., rv], rtol=0, atol=1e-6)


def test_real_input_cubic_and_capacity():
    n = 512
    x = ((np.arange(n, dtype=np.float64) / n) ** 3).astype(np.float32)
    st = tf.farrow_init(dtype=torch.float32, device="cpu")
    _, (y, v) = tf.farrow_apply(st, torch.from_numpy(x), 7, 3)
    _, (jy, jv) = jf.farrow_apply(jf.farrow_init(dtype=jnp.float32), jnp.asarray(x), 7, 3)
    assert y.dtype == torch.float32 and np.array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_allclose(y.numpy()[v.numpy()], np.asarray(jy)[np.asarray(jv)], rtol=0,
                               atol=1e-6)
    assert tf.farrow_capacity(1000, 7, 13) == jf.farrow_capacity(1000, 7, 13)
    assert tf.make_farrow_ratio(48000, 44100) == (160, 147)
    assert np.array_equal(tf.LAGRANGE_C, jf.LAGRANGE_C)
