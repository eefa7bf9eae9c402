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
- the CUDA kernels' schedules, mirrored in torch, bit for bit against the
  plain versions and the JAX references: K14's column-slot form
  (`edges_decode_colslot`: row-owned messages, no V) and K15's compressed
  check state (`qc_decode_compressed`: a1, a2, arg and sign bits), on the
  codes above, an H with a degree-1 row, a layer of degree 20 (two state
  words), and LLRs with exact +-0 and tied magnitudes;
- the launch geometries (`edges_geometry`, `qc_geometry`) and that every QC
  plan the earlier geometry (every message in shared memory) took still has
  one;
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
from tests.torch_threads import one_torch_thread  # noqa: F401

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
    """K15's launch geometry: at the phase-3 code 8 codewords a block, 4 a
    thread, 256 threads and 98,652 B of shared memory (posteriors 6 kB and
    check state 6 kB a codeword, then the slab and layer tables), so two
    blocks share an SM; fewer codewords, 2 a thread, where a batch would
    leave SMs idle."""
    z = 128
    plan = tk.plan_qc(tq.make_dual_diagonal_base(4, 12, z, seed=0), z)
    assert plan.n_blocks == 41
    assert tk.qc_geometry(plan) == tk.QcGeometry(cw=8, cpt=4, threads=256, smem=98652, words=1,
                                                 state="shared")
    small = tk.qc_geometry(tk.plan_qc(np.zeros((3, 8), np.int64), 16))
    assert (small.cw, small.cpt, small.threads, small.words) == (8, 4, 32, 1)
    # a small batch takes fewer codewords a block, so that more SMs work
    assert [tk.qc_geometry(plan, b)[:2] for b in (4096, 1049, 1048, 199, 5)] == [
        (8, 4), (8, 4), (4, 2), (2, 2), (2, 2)]


def _old_qc_smem(plan) -> int:
    """Shared bytes a codeword under the earlier K15 geometry (posteriors and
    every message): the plans it took are those within SMEM_MAX."""
    return (plan.nb + plan.n_blocks) * plan.z * 4


@pytest.mark.parametrize("mb,nb,z,deg,want", [
    (4, 12, 896, None, (2, 2, 896, "shared")),      # two codewords: past the target
    (12, 24, 64, None, (4, 2, 128, "shared")),      # 12 layers of degree 24
    (2, 4, 4096, None, (1, 1, 1024, "shared")),     # one codeword, rows looped
    (2, 4, 6144, 2, (1, 1, 1024, "device")),        # degree 2: the state fits no more
    (2, 40, 64, None, (8, 4, 128, "shared")),       # a layer of degree 40: three words
])
def test_qc_geometry_fallbacks(mb, nb, z, deg, want):
    """Past the target K15 takes fewer codewords a block, then one, then
    keeps the check state in device memory. Each of these plans was within
    the earlier geometry's limit, so none is refused."""
    base = np.zeros((mb, nb), np.int64)
    if deg is not None:
        base[:] = -1
        for i in range(mb):
            base[i, i * deg:(i + 1) * deg] = 0
    plan = tk.plan_qc(base, z)
    assert _old_qc_smem(plan) <= tk.SMEM_MAX
    geo = tk.qc_geometry(plan)
    assert (geo.cw, geo.cpt, geo.threads, geo.state) == want
    assert geo.smem <= tk.SMEM_MAX
    assert geo.words == -(-max(len(c) for c, _ in plan.layers) // tk.QC_CHUNK)


def test_qc_geometry_refuses_only_what_fits_nowhere():
    plan = tk.plan_qc(np.zeros((2, 8), np.int64), 8192)      # posteriors alone 256 kB
    assert _old_qc_smem(plan) > tk.SMEM_MAX
    with pytest.raises(ValueError, match="shared memory"):
        tk.qc_geometry(plan)


@pytest.mark.parametrize("n,want", [(504, (8, 4, 512, 81920)), (120, (8, 4, 128, 20480)),
                                    (7998, (1, 1, 1024, 160000))])
def test_edges_geometry(n, want):
    """K14's launch geometry: 8 codewords a block and 4 a thread (10 kB of
    shared memory a codeword at n = 504), fewer where they do not fit (a
    banded (3,6) H at n = 7998)."""
    if n == 7998:
        h = np.zeros((n // 2, n), np.int8)
        for r in range(n // 2):
            h[r, (2 * r + np.arange(6)) % n] = 1
    else:
        h = jl.make_regular_ldpc(n, 3, 6, seed=0)
    geo = tk.edges_geometry(tk.plan_edges(h))
    assert (geo.cw, geo.cpt, geo.threads, geo.smem) == want


def _zeros_and_ties(llr: np.ndarray) -> np.ndarray:
    """LLRs with exact +0 and -0 and runs of tied magnitudes of both signs."""
    out = llr.copy()
    out[3, :5] = 0.0
    out[4, 5:9] = -0.0
    out[7:12] = 2.0
    out[12:15] = -2.0
    out[20, ::2] = -0.0
    return out


def test_edges_colslot_mirror_equals_plain_and_jax(edges):
    """K14's schedule (column slots only, a row's own old message read in
    its slot) == plain K14 == the JAX reference, bit for bit."""
    h, *_, lf = edges
    tp = tk.plan_edges(h)
    ref = np.asarray(jk.ldpc_decode_edges_ref(jk.plan_edges(h), jnp.asarray(lf), iters=ITERS))
    got = tk.edges_decode_colslot(tp, torch.as_tensor(lf), ITERS).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, tk.ldpc_decode_edges_ref(tp, torch.as_tensor(lf),
                                                                 ITERS).numpy())


def test_edges_colslot_mirror_degree1_row_zeros_ties():
    """A degree-1 check row (its message stays 0), exact +-0 LLRs and tied
    magnitudes: the mirror == plain == JAX, bit for bit."""
    h = jl.make_regular_ldpc(120, 3, 6, seed=1)
    h[2, np.flatnonzero(h[2])[1:]] = 0
    rng = np.random.default_rng(11)
    lf = _zeros_and_ties((4.0 * rng.standard_normal((120, 24))).astype(np.float32))
    tp = tk.plan_edges(h)
    ref = np.asarray(jk.ldpc_decode_edges_ref(jk.plan_edges(h), jnp.asarray(lf), iters=4))
    got = tk.edges_decode_colslot(tp, torch.as_tensor(lf), 4).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, tk.ldpc_decode_edges_ref(tp, torch.as_tensor(lf),
                                                                 4).numpy())


@pytest.mark.parametrize("case", ["qc", "zeros_ties", "degree20"])
def test_qc_compressed_mirror_equals_plain_and_jax(qc, case):
    """K15's schedule (no message stored: a1, a2, arg and sign bits rebuild
    the old ones) == plain K15 == the eager JAX reference, bit for bit: the
    z = 16 code with zero blocks, the same with exact +-0 LLRs and tied
    magnitudes, and a layer of degree 20 (two state words) at z = 8."""
    base, z, *_, lf = qc
    lf = lf[:, :24]
    if case == "zeros_ties":
        lf = _zeros_and_ties(lf)
    elif case == "degree20":
        base, z = np.zeros((2, 20), np.int64), 8
        base[0, 1::3] = -1
        base[1] = np.arange(20) % z
        lf = (3.0 * np.random.default_rng(3).standard_normal((20 * z, 8))).astype(np.float32)
    iters = 3 if case == "degree20" else 4
    tp = tk.plan_qc(base, z)
    ref = np.asarray(jk.qc_decode_layered_ref(jk.plan_qc(base, z), jnp.asarray(lf), iters=iters))
    got = tk.qc_decode_compressed(tp, torch.as_tensor(lf), iters).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, tk.qc_decode_layered_ref(tp, torch.as_tensor(lf),
                                                                 iters).numpy())


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
