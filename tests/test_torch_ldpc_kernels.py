"""Port vs JAX package: the LDPC decoder kernels' plain versions and
factories, ``kernels/ldpc_pallas`` (K14 edge-form, K15 QC layered).

Contracts (JAX Pallas kernels in interpret mode, iters <= 4 at z = 16 where
they are jitted, to keep XLA:CPU compile times small):

- `plan_edges` and `plan_qc` equal (arrays, degrees, layers);
- plain K14 == JAX `ldpc_decode_edges_ref` and == JAX `make_ldpc_kernel`,
  bit for bit (every message on the bf16 grid), on a regular n = 120 code
  and an irregular one; `make_ldpc_decoder` bits / info / ok equal;
- plain K15 == the eager JAX `qc_decode_layered_ref`, bit for bit (eager
  dispatch rounds every product and difference on its own, as the port does);
  against the jitted JAX kernel, whose compiler fuses ``alpha*es*em - old``
  into one rounding, decisions equal and posteriors within 8 ulp of the
  largest posterior (rtol 1e-6 of max |post|; measured about 2.5e-7);
- `make_qc_decoder` and `make_qc_decoder_t` decisions and ok equal;
- the factories' ValueErrors (shape, b_tile, dtype, device).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu import ldpc as jl
from srcdsp_tpu import qcldpc as jq
from srcdsp_tpu.kernels import ldpc_pallas as jk
from srcdsp_tpu_torch import convert
from srcdsp_tpu_torch import ldpc as tl
from srcdsp_tpu_torch import qcldpc as tq
from srcdsp_tpu_torch.kernels import ldpc_pallas as tk

ITERS = 6


def _llr(cw, sigma, rng):
    return (2.0 / sigma ** 2 * ((1.0 - 2.0 * cw) + sigma * rng.standard_normal(cw.shape))
            ).astype(np.float32)


def _irregular_h():
    h = jl.make_regular_ldpc(120, 3, 6, seed=3)
    h[0, np.flatnonzero(h[0])[0]] = 0
    h[5, np.flatnonzero(h[5])[0]] = 0
    return h


@pytest.fixture(scope="module", params=["regular", "irregular"])
def edges(request):
    h = jl.make_regular_ldpc(120, 3, 6, seed=1) if request.param == "regular" else _irregular_h()
    jc = jl.make_ldpc_code(h)
    rng = np.random.default_rng(7)
    u = rng.integers(0, 2, (24, jc.k))
    cw = np.asarray(jl.ldpc_encode(jc, jnp.asarray(u)))
    llr = _llr(cw, 0.5, rng)
    lf = np.zeros((h.shape[1], 128), np.float32)
    lf[:, :24] = llr.T
    return h, jc, tl.make_ldpc_code(h, device="cpu"), u, llr, lf


def test_plan_edges_equal(edges):
    h = edges[0]
    jp, tp = jk.plan_edges(h), tk.plan_edges(h)
    assert set(tp._fields) == set(jp._fields) - {"perm"}
    for f in tp._fields:
        np.testing.assert_array_equal(np.asarray(getattr(tp, f)), np.asarray(getattr(jp, f)), f)
    # the JAX kernel's 0/1 matrix has its ones exactly where col_src points
    perm = np.zeros(np.asarray(jp.perm).shape, np.float32)
    fed = tp.col_src >= 0
    perm[np.flatnonzero(fed), tp.col_src[fed]] = 1.0
    np.testing.assert_array_equal(perm, np.asarray(jp.perm))
    conv = convert.edge_plan_from(jp)
    for f in tp._fields:
        np.testing.assert_array_equal(np.asarray(getattr(conv, f)), np.asarray(getattr(tp, f)), f)


def test_edges_plain_bitexact_vs_jax_ref_and_kernel(edges):
    h, *_, lf = edges
    jp, tp = jk.plan_edges(h), tk.plan_edges(h)
    ref = np.asarray(jk.ldpc_decode_edges_ref(jp, jnp.asarray(lf), iters=ITERS))
    kern = np.asarray(jk.make_ldpc_kernel(jp, iters=ITERS, interpret=True)(jnp.asarray(lf)))
    got = tk.make_ldpc_kernel(tp, iters=ITERS, device="cpu")(torch.as_tensor(lf)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, kern)
    np.testing.assert_array_equal(tk.ldpc_decode_edges_ref(tp, torch.as_tensor(lf), ITERS).numpy(),
                                  ref)


def test_edge_decoder_equal(edges):
    h, jc, tc, u, llr, _ = edges
    jp = jk.plan_edges(h)
    want = jk.ldpc_decode_pallas(jc, jp, jnp.asarray(llr), iters=10, interpret=True)
    dec = tk.make_ldpc_decoder(tc, convert.edge_plan_from(jp), iters=10, device="cpu")
    got = dec(torch.as_tensor(llr))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert bool(got[2].all())
    np.testing.assert_array_equal(got[1].numpy(), u)
    again = tk.ldpc_decode_pallas(tc, tk.plan_edges(h), torch.as_tensor(llr), iters=10)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.fixture(scope="module")
def qc():
    z = 16
    base = jq.make_qc_base(3, 8, z, seed=2)
    base[0, 3] = -1
    base[2, 6] = -1
    jc = jq.make_qc_ldpc(base, z)
    rng = np.random.default_rng(5)
    u = rng.integers(0, 2, (16, jc.k))
    cw = np.asarray(jl.ldpc_encode(jc, jnp.asarray(u)))
    llr = _llr(cw, 0.6, rng)
    lf = np.zeros((jc.n, 128), np.float32)
    lf[:, :16] = llr.T
    return base, z, jc, tq.make_qc_ldpc(base, z, device="cpu"), cw, llr, lf


def test_plan_qc_equal(qc):
    base, z, *_ = qc
    assert tk.plan_qc(base, z) == jk.plan_qc(base, z)
    assert convert.qc_plan_from(jk.plan_qc(base, z)) == tk.plan_qc(base, z)


def test_qc_plain_bitexact_vs_eager_jax_ref(qc):
    base, z, *_, lf = qc
    ref = np.asarray(jk.qc_decode_layered_ref(jk.plan_qc(base, z), jnp.asarray(lf), iters=4))
    got = tk.qc_decode_layered_ref(tk.plan_qc(base, z), torch.as_tensor(lf), iters=4).numpy()
    np.testing.assert_array_equal(got, ref)


def test_qc_plain_vs_jitted_jax_kernel(qc):
    base, z, *_, lf = qc
    want = np.asarray(jax.jit(jk.make_qc_kernel(jk.plan_qc(base, z), iters=4, interpret=True))(
        jnp.asarray(lf)))
    got = tk.make_qc_kernel(tk.plan_qc(base, z), iters=4, device="cpu")(torch.as_tensor(lf)).numpy()
    np.testing.assert_array_equal(got < 0, want < 0)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_qc_decoders_equal(qc):
    base, z, jc, tc, cw, llr, _ = qc
    jp, tp = jk.plan_qc(base, z), tk.plan_qc(base, z)
    want = jk.qc_decode_layered_pallas(jc, jp, jnp.asarray(llr), iters=4, interpret=True)
    got = tk.make_qc_decoder(tc, tp, iters=4, device="cpu")(torch.as_tensor(llr))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    ok = got[2].numpy()
    assert ok.mean() > 0.9
    np.testing.assert_array_equal(got[0].numpy()[ok], cw[ok])
    bits_t, ok_t = tk.make_qc_decoder_t(tc, tp, iters=4, b_tile=16, device="cpu")(
        torch.as_tensor(np.ascontiguousarray(llr.T)))
    jb_t, jok_t = jk.make_qc_decoder_t(jc, jp, iters=4, b_tile=16, interpret=True)(
        jnp.asarray(llr.T))
    np.testing.assert_array_equal(bits_t.numpy(), np.asarray(jb_t))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(jok_t))
    np.testing.assert_array_equal(bits_t.numpy().T, got[0].numpy())
    again = tk.qc_decode_layered_pallas(tc, tp, torch.as_tensor(llr), iters=4)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_qc_codewords_per_block():
    z = 128
    plan = tk.plan_qc(tq.make_dual_diagonal_base(4, 12, z, seed=0), z)
    assert plan.n_blocks == 41
    assert tk.qc_codewords_per_block(plan) == 4        # 108.5 kB of shared memory
    assert tk.qc_codewords_per_block(tk.plan_qc(np.zeros((3, 8), np.int64), 16)) == 8


def test_value_errors(qc):
    base, z, jc, tc, *_ = qc
    with pytest.raises(ValueError, match="multiple of 8"):
        tk.plan_qc(np.zeros((2, 4), np.int64), z=12)
    bad = -np.ones((2, 4), np.int64)
    bad[0, 0] = 1
    with pytest.raises(ValueError, match="degree < 2"):
        tk.plan_qc(bad, z=16)
    with pytest.raises(ValueError, match="row degree"):
        tk.plan_edges(np.eye(4))
    plan = tk.plan_qc(base, z)
    run = tk.make_qc_kernel(plan, iters=2, device="cpu")
    with pytest.raises(ValueError, match="tile 128"):
        run(torch.zeros((tc.n, 100)))
    with pytest.raises(ValueError, match="vs plan"):
        run(torch.zeros((tc.n - 1, 128)))
    with pytest.raises(ValueError, match="float32"):
        run(torch.zeros((tc.n, 128), dtype=torch.float64))
    with pytest.raises(ValueError, match="tile 128"):
        tk.make_qc_decoder_t(tc, plan, device="cpu")(torch.zeros((tc.n, 64)))
    ep = tk.plan_edges(jl.make_regular_ldpc(120, 3, 6, seed=1))
    with pytest.raises(ValueError, match="tile 128"):
        tk.make_ldpc_kernel(ep, device="cpu")(torch.zeros((120, 64)))
    with pytest.raises(ValueError, match="float32"):
        tk.make_ldpc_kernel(ep, device="cpu")(torch.zeros((120, 128), dtype=torch.bfloat16))
