"""Port vs JAX package: MLSE and the adaptive equalizers, ``chains/mlse`` and
``chains/equalizer``.

Fixtures (numpy, seeded), the reference tests' channels
(``tests/unit/test_mlse.py``, ``test_equalizer.py``) at shorter lengths:
MLSE over the spectral-null channel [0.5, 0.7071, 0.5] (BPSK, clean and at
12 dB) and a QPSK memory-one channel; block LMS trained (2 channels x 2,048
QPSK symbols over [1, 0.45-0.2j, -0.25+0.1j] at 30 dB), decision-directed,
fractionally spaced (sps 2) and CMA (8,192 symbols); RLS (L 11, 512 symbols) and the DFE
(9 + 8 taps, 1,024 symbols over a long-postcursor channel). JAX runs
each once per module (jitted).

Contracts:

- bit-exact: MLSE decisions, the slicer, the framing, and the decisions of
  every equalizer after convergence (the slicer on its output);
- every equalizer's outputs, MSE or |e|^2, taps and states within rel L2
  1e-5, though each is a recursion over its blocks or symbols: measured
  here block LMS / CMA <= 2.3e-7, RLS (y, P) <= 2.8e-7, the DFE's y 1.7e-7
  and its decision-directed |e|^2 2.8e-6 (small values near convergence);
- a JAX state handed to the port mid-stream gives JAX's rest of the stream
  (LMS, RLS, DFE).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu.chains import equalizer as jeq
from srcdsp_tpu.chains import mlse as jml
from srcdsp_tpu_torch import convert
from srcdsp_tpu_torch.chains import equalizer as teq
from srcdsp_tpu_torch.chains import mlse as tml
from srcdsp_tpu_torch.demap import psk_points
from tests.torch_threads import one_torch_thread  # noqa: F401

REL = 1e-5


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _channel_out(h, s):
    return np.convolve(s, h)[: len(s)]


# ---------- MLSE ----------

def _mlse_case(name):
    if name == "null_clean":
        h, order, n, seed, noise = [0.5, 0.7071, 0.5], 2, 512, 1, 0.0
    elif name == "null_12db":
        h, order, n, seed, noise = [0.5, 0.7071, 0.5], 2, 1024, 2, None
    elif name == "qpsk_mem1":
        h, order, n, seed, noise = [1.0, 0.6j], 4, 512, 3, 0.05
    else:
        h, order, n, seed, noise = [1.0], 4, 128, 0, 0.05
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, order, n)
    y = _channel_out(np.asarray(h), psk_points(order).astype(np.complex128)[idx])
    if noise is None:
        noise = np.sqrt(np.mean(np.abs(y) ** 2) / 10 ** 1.2 / 2)
    y = y + noise * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return h, order, idx, y.astype(np.complex64)


@pytest.mark.parametrize("name", ["null_clean", "null_12db", "qpsk_mem1", "flat"])
def test_mlse_equal(name):
    h, order, idx, y = _mlse_case(name)
    jt = jml.make_mlse(h, order=order)
    tt = tml.make_mlse(h, order=order)
    for f in ("points", "h", "expected"):
        np.testing.assert_array_equal(getattr(tt, f), getattr(jt, f))
    got = tml.mlse_equalize(convert.mlse_trellis_from(jt), torch.as_tensor(y))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jml.mlse_equalize(jt, jnp.asarray(y))))
    if name != "null_12db":
        assert np.mean(got.numpy()[4:] != idx[4:]) == 0.0


# ---------- block LMS / CMA ----------

def _qpsk(n, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 4, n)
    return np.exp(1j * (np.pi / 4 + np.pi / 2 * idx)).astype(np.complex64)


def _chan(s, h, snr_db, seed):
    x = np.convolve(s, h)[: len(s)].astype(np.complex64)
    rng = np.random.default_rng(seed)
    p = np.mean(np.abs(x) ** 2)
    n = rng.standard_normal(len(x)) + 1j * rng.standard_normal(len(x))
    return (x + np.sqrt(p * 10 ** (-snr_db / 10) / 2) * n).astype(np.complex64)


H1 = np.array([1.0, 0.45 - 0.2j, -0.25 + 0.1j], np.complex64)


@pytest.fixture(scope="module")
def blocks():
    s = np.stack([_qpsk(2048, 2), _qpsk(2048, 3)])
    x = np.stack([_chan(s[0], H1, 30, 1), _chan(s[1], H1, 30, 4)])
    out = {"s": s, "x": x}
    train = jax.jit(lambda st, v, d: jeq.lms_equalize(v, st, mu=0.1, block=64, d=d))
    dd = jax.jit(lambda st, v: jeq.lms_equalize(v, st, mu=0.05, block=64,
                                                offset=np.pi / 4))
    st0 = jeq.eq_init(11, channel_shape=(2,))
    half = 1024
    st1, y1, m1 = train(st0, jnp.asarray(x[:, :half]), jnp.asarray(s[:, :half]))
    st2, y2, m2 = dd(st1, jnp.asarray(x[:, half:]))
    out["train"] = (st1, np.asarray(y1), np.asarray(m1))
    out["dd"] = (st2, np.asarray(y2), np.asarray(m2))
    sc = _qpsk(8192, 4)
    xc = _chan(sc, np.array([1.0, 0.35 - 0.2j, -0.15 + 0.1j], np.complex64), 30, 5)
    out["cma_x"] = xc
    out["cma"] = jax.jit(lambda st, v: jeq.cma_equalize(v, st, mu=0.05, block=64))(
        jeq.eq_init(11), jnp.asarray(xc))
    x2 = np.repeat(sc[:1024], 2) * np.complex64(1.0)
    x2 = _chan(x2, np.array([1.0, 0.0, 0.3 - 0.1j], np.complex64), 30, 6)
    out["fs_x"], out["fs_s"] = x2, sc[:1024]
    out["fs"] = jax.jit(lambda st, v, d: jeq.lms_equalize(v, st, mu=0.05, block=32, sps=2, d=d))(
        jeq.eq_init(12), jnp.asarray(x2), jnp.asarray(sc[:1024]))
    return out


def _check_block(got, want, rtol=REL):
    st, y, mse = got
    jst, jy, jmse = want
    assert y.dtype == torch.complex64
    assert rel(y.numpy(), jy) <= rtol and rel(mse.numpy(), jmse) <= rtol
    assert rel(st.w.numpy(), jst.w) <= rtol and rel(st.tail.numpy(), jst.tail) <= rtol


def _decisions(y):
    return np.asarray(jeq.psk_slicer(jnp.asarray(np.asarray(y)), 4, offset=np.pi / 4))


def test_lms_train_then_dd_equal(blocks):
    x, s = blocks["x"], blocks["s"]
    st = teq.eq_init(11, channel_shape=(2,), device="cpu")
    got = teq.lms_equalize(torch.as_tensor(x[:, :1024]), st, mu=0.1, block=64,
                           d=torch.as_tensor(s[:, :1024]))
    _check_block(got, blocks["train"])
    got2 = teq.lms_equalize(torch.as_tensor(x[:, 1024:]), got[0], mu=0.05, block=64,
                            offset=np.pi / 4)
    _check_block(got2, blocks["dd"])
    dec = teq.psk_slicer(got2[1], 4, offset=np.pi / 4).numpy()
    np.testing.assert_array_equal(dec, _decisions(blocks["dd"][1]))
    assert float(got2[2][:, -1].max()) < 0.05       # converged: 0.040 and 0.042 here


def test_lms_jax_state_handoff(blocks):
    st = convert.eq_state_from(blocks["train"][0], device="cpu")
    got = teq.lms_equalize(torch.as_tensor(blocks["x"][:, 1024:]), st, mu=0.05, block=64,
                           offset=np.pi / 4)
    _check_block(got, blocks["dd"])


def test_cma_equal(blocks):
    got = teq.cma_equalize(torch.as_tensor(blocks["cma_x"]), teq.eq_init(11, device="cpu"),
                           mu=0.05, block=64)
    _check_block(got, blocks["cma"])
    mod = np.abs(got[1].numpy()[-2048:])
    assert np.std(mod) < 0.08


def test_fractionally_spaced_lms_equal(blocks):
    got = teq.lms_equalize(torch.as_tensor(blocks["fs_x"]), teq.eq_init(12, device="cpu"),
                           mu=0.05, block=32, sps=2, d=torch.as_tensor(blocks["fs_s"]))
    _check_block(got, blocks["fs"])


@pytest.mark.parametrize("ntaps,sps", [(4, 1), (5, 2)])
def test_frames_and_slicer_equal(ntaps, sps):
    x = np.arange(1, 20, dtype=np.complex64) * np.complex64(1 + 0.5j)
    np.testing.assert_array_equal(teq.make_eq_frames(torch.as_tensor(x), ntaps, sps).numpy(),
                                  np.asarray(jeq.make_eq_frames(jnp.asarray(x), ntaps, sps)))
    z = np.exp(1j * np.linspace(-3.1, 3.1, 101)).astype(np.complex64)
    for order, off in ((4, np.pi / 4), (2, 0.0), (8, 0.1)):
        assert rel(teq.psk_slicer(torch.as_tensor(z), order, off).numpy(),
                   jeq.psk_slicer(jnp.asarray(z), order, off)) <= REL


# ---------- RLS / DFE ----------

@pytest.fixture(scope="module")
def seq():
    rng = np.random.default_rng(0)
    s = np.exp(1j * (2 * np.pi * (rng.integers(0, 4, 512) + 0.5) / 4)).astype(np.complex64)
    h = np.asarray([0.25, 1.0, 0.35 - 0.2j, 0.15j], np.complex64)
    x = (np.convolve(s, h)[:512]
         + 0.02 * (rng.standard_normal(512) + 1j * rng.standard_normal(512))).astype(np.complex64)
    rls = jax.jit(lambda st, v, d: jeq.rls_equalize(v, st, lam=0.995, d=d, delay=5))
    r1 = rls(jeq.rls_init(11), jnp.asarray(x[:256]), jnp.asarray(s[:256]))
    r2 = rls(r1[0], jnp.asarray(x[256:]), jnp.asarray(s[256:]))
    rng = np.random.default_rng(7)
    sd = np.exp(1j * (2 * np.pi * (rng.integers(0, 4, 1024) + 0.5) / 4)).astype(np.complex64)
    hd = np.asarray([1.0, 0.0, 0.55, 0.0, 0.4, 0.0, 0.3], np.complex64)
    xd = (np.convolve(sd, hd)[:1024]
          + 0.03 * (rng.standard_normal(1024) + 1j * rng.standard_normal(1024))).astype(np.complex64)
    dfe = jax.jit(lambda st, v, d: jeq.dfe_equalize(v, st, mu=0.02, d=d, delay=4))
    d1 = dfe(jeq.dfe_init(9, 8), jnp.asarray(xd[:768]), jnp.asarray(sd[:768]))
    d2 = jax.jit(lambda st, v: jeq.dfe_equalize(v, st, mu=0.02, offset=np.pi / 4))(
        d1[0], jnp.asarray(xd[768:]))
    return dict(s=s, x=x, r1=r1, r2=r2, sd=sd, xd=xd, d1=d1, d2=d2)


def _check_rec(got, want, fields):
    st, y, err = got
    jst, jy, jerr = want
    assert rel(y.numpy(), jy) <= REL and rel(err.numpy(), jerr) <= REL
    for f in fields:
        assert rel(getattr(st, f).numpy(), getattr(jst, f)) <= REL, f
    np.testing.assert_array_equal(_decisions(y.numpy())[64:], _decisions(jy)[64:])


def test_rls_equal(seq):
    st = teq.rls_init(11, device="cpu")
    g1 = teq.rls_equalize(torch.as_tensor(seq["x"][:256]), st, lam=0.995,
                          d=torch.as_tensor(seq["s"][:256]), delay=5)
    _check_rec(g1, seq["r1"], ("w", "p", "tail"))
    g2 = teq.rls_equalize(torch.as_tensor(seq["x"][256:]), g1[0], lam=0.995,
                          d=torch.as_tensor(seq["s"][256:]), delay=5)
    _check_rec(g2, seq["r2"], ("w", "p", "tail"))
    assert float(g2[2][-64:].mean()) < 0.01


def test_rls_jax_state_handoff(seq):
    st = convert.rls_state_from(seq["r1"][0], device="cpu")
    got = teq.rls_equalize(torch.as_tensor(seq["x"][256:]), st, lam=0.995,
                           d=torch.as_tensor(seq["s"][256:]), delay=5)
    _check_rec(got, seq["r2"], ("w", "p", "tail"))


def test_dfe_equal(seq):
    g1 = teq.dfe_equalize(torch.as_tensor(seq["xd"][:768]), teq.dfe_init(9, 8, device="cpu"),
                          mu=0.02, d=torch.as_tensor(seq["sd"][:768]), delay=4)
    _check_rec(g1, seq["d1"], ("ff", "fb", "tail", "past"))
    g2 = teq.dfe_equalize(torch.as_tensor(seq["xd"][768:]), g1[0], mu=0.02, offset=np.pi / 4)
    _check_rec(g2, seq["d2"], ("ff", "fb", "tail", "past"))
    assert float(g2[2][-128:].mean()) < 0.02


def test_dfe_jax_state_handoff(seq):
    st = convert.dfe_state_from(seq["d1"][0], device="cpu")
    got = teq.dfe_equalize(torch.as_tensor(seq["xd"][768:]), st, mu=0.02, offset=np.pi / 4)
    _check_rec(got, seq["d2"], ("ff", "fb", "tail", "past"))
