"""Port vs JAX package: the LDPC codecs, ``ldpc`` and ``qcldpc``.

Contracts:

- host construction equal element for element from the same seed: H, ``gp``
  and ``col_perm`` of `make_regular_ldpc` + `make_ldpc_code` (n 120, 504),
  the QC base matrices and their codes (z 16), `load_qc_table`;
- `ldpc_encode` and `qc_encode_dual_diagonal`: codewords equal;
- the dense decoders `ldpc_decode` and `ldpc_decode_layered`: bits, info and
  ok equal (they return no posteriors); their check update `minsum_c2v`
  within 1e-6 relative (the same products; the frameworks may group the sign
  product differently, a rounding of the last bit);
- the reference's ValueErrors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu import ldpc as jl
from srcdsp_tpu import qcldpc as jq
from srcdsp_tpu_torch import convert
from srcdsp_tpu_torch import ldpc as tl
from srcdsp_tpu_torch import qcldpc as tq
from tests.torch_threads import one_torch_thread  # noqa: F401


def _code_equal(jc, tc):
    for f in ("h", "gp", "col_perm"):
        np.testing.assert_array_equal(np.asarray(getattr(jc, f)), getattr(tc, f).numpy(), f)
    assert (jc.n, jc.k) == (tc.n, tc.k)


@pytest.mark.parametrize("n,seed", [(120, 1), (504, 0)])
def test_regular_code_construction_equal(n, seed):
    h = jl.make_regular_ldpc(n, 3, 6, seed=seed)
    np.testing.assert_array_equal(tl.make_regular_ldpc(n, 3, 6, seed=seed), h)
    _code_equal(jl.make_ldpc_code(h), tl.make_ldpc_code(h, device="cpu"))


def test_qc_construction_equal():
    z = 16
    for jb, tb in ((jq.make_qc_base(3, 8, z, seed=2), tq.make_qc_base(3, 8, z, seed=2)),
                   (jq.make_dual_diagonal_base(4, 12, z, seed=1),
                    tq.make_dual_diagonal_base(4, 12, z, seed=1))):
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(tq.qc_expand(tb, z), jq.qc_expand(jb, z))
        _code_equal(jq.make_qc_ldpc(jb, z), tq.make_qc_ldpc(tb, z, device="cpu"))


def test_ldpc_code_from_jax():
    h = jl.make_regular_ldpc(120, 3, 6, seed=1)
    _code_equal(jl.make_ldpc_code(h), convert.ldpc_code_from(jl.make_ldpc_code(h), device="cpu"))


@pytest.fixture(scope="module")
def regular():
    h = jl.make_regular_ldpc(120, 3, 6, seed=1)
    jc, tc = jl.make_ldpc_code(h), tl.make_ldpc_code(h, device="cpu")
    rng = np.random.default_rng(7)
    u = rng.integers(0, 2, (24, jc.k))
    cw = np.asarray(jl.ldpc_encode(jc, jnp.asarray(u)))
    sigma = 0.5
    llr = (2.0 / sigma ** 2 * ((1.0 - 2.0 * cw) + sigma * rng.standard_normal(cw.shape))
           ).astype(np.float32)
    return jc, tc, u, cw, llr


def test_encode_equal(regular):
    jc, tc, u, cw, _ = regular
    np.testing.assert_array_equal(tl.ldpc_encode(tc, torch.as_tensor(u)).numpy(), cw)


def test_dual_diagonal_encode_equal():
    z = 16
    base = jq.make_dual_diagonal_base(4, 12, z, seed=1)
    u = np.random.default_rng(3).integers(0, 2, (6, 8 * z))
    want = np.asarray(jq.qc_encode_dual_diagonal(base, z, jnp.asarray(u)))
    np.testing.assert_array_equal(tq.qc_encode_dual_diagonal(base, z, torch.as_tensor(u)).numpy(),
                                  want)
    np.testing.assert_array_equal(tq.qc_encode_dual_diagonal(base, z, u).numpy(), want)
    # a codeword of the code: every check holds
    code = tq.make_qc_ldpc(base, z, device="cpu")
    assert bool(tl.syndrome_ok(torch.as_tensor(want), code.h).all())


def _decisions_equal(jb, tb):
    """Bits, info and ok equal."""
    for a, b in zip(jb, tb):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_dense_decode_equal(regular):
    jc, tc, u, cw, llr = regular
    j = jl.ldpc_decode(jc, jnp.asarray(llr), iters=8)
    t = tl.ldpc_decode(tc, torch.as_tensor(llr), iters=8)
    _decisions_equal(j, t)
    assert bool(t[2].all())
    np.testing.assert_array_equal(t[1].numpy(), u)


def test_minsum_c2v_close():
    h = jl.make_regular_ldpc(120, 3, 6, seed=1).astype(np.float32)
    v = (np.random.default_rng(2).standard_normal((3, *h.shape)) * h).astype(np.float32)
    want = np.asarray(jl.minsum_c2v(jnp.asarray(h), jnp.asarray(v), 0.8125))
    got = tl.minsum_c2v(torch.as_tensor(h), torch.as_tensor(v), 0.8125).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.fixture(scope="module")
def qc():
    z = 16
    base = jq.make_qc_base(3, 8, z, seed=2)
    base[0, 3] = -1
    base[2, 6] = -1
    jc, tc = jq.make_qc_ldpc(base, z), tq.make_qc_ldpc(base, z, device="cpu")
    rng = np.random.default_rng(5)
    u = rng.integers(0, 2, (16, jc.k))
    cw = np.asarray(jl.ldpc_encode(jc, jnp.asarray(u)))
    sigma = 0.6
    llr = (2.0 / sigma ** 2 * ((1.0 - 2.0 * cw) + sigma * rng.standard_normal(cw.shape))
           ).astype(np.float32)
    return base, z, jc, tc, cw, llr


def test_layered_decode_equal(qc):
    _, z, jc, tc, cw, llr = qc
    j = jq.ldpc_decode_layered(jc, jnp.asarray(llr), z=z, iters=4)
    t = tq.ldpc_decode_layered(tc, torch.as_tensor(llr), z=z, iters=4)
    _decisions_equal(j, t)
    ok = t[2].numpy()
    assert ok.mean() > 0.9
    np.testing.assert_array_equal(t[0].numpy()[ok], cw[ok])


def test_load_qc_table_equal():
    text = """
    # a 2 x 4 table
    1, 0, -1, 3
    -  2  1  0
    """
    np.testing.assert_array_equal(tq.load_qc_table(text), jq.load_qc_table(text))
    for bad in ("", "1 2\n3"):
        with pytest.raises(ValueError):
            tq.load_qc_table(bad)


def test_value_errors():
    with pytest.raises(ValueError, match="not divisible"):
        tl.make_regular_ldpc(100, 3, 6)
    with pytest.raises(ValueError, match="no info bits"):
        tl.make_ldpc_code(np.eye(4, dtype=np.uint8), device="cpu")
    with pytest.raises(ValueError, match="nb > mb"):
        tq.make_dual_diagonal_base(4, 4, 16)
    with pytest.raises(ValueError, match="mb >= 3"):
        tq.make_dual_diagonal_base(2, 8, 16)
    with pytest.raises(ValueError, match="increase z"):
        tq.make_qc_base(4, 8, 2)
    code = tq.make_qc_ldpc(tq.make_dual_diagonal_base(4, 12, 16, seed=1), 16, device="cpu")
    with pytest.raises(ValueError, match="not divisible by layer size"):
        tq.ldpc_decode_layered(code, torch.zeros(4, 192), z=24)
    with pytest.raises(ValueError, match="K = 128"):
        tq.qc_encode_dual_diagonal(tq.make_dual_diagonal_base(4, 12, 16, seed=1), 16,
                                   np.zeros((2, 100), np.int64))
