"""Port vs JAX package: `array` (steering, covariance, DOA spectra, MVDR,
beamforming) and `mimo` (ZF, MMSE, exact ML).

Fixtures (numpy, seeded): the reference tests' scenes: two far-field
Gaussian sources on an 8-element half-wavelength ULA (and a close pair),
2x2 channels with 16-QAM at 80 dB and QPSK through an ill-conditioned
channel at 14 dB, 4x4 QPSK, per-bin 2x2 channels. The JAX side runs once per
module.

Contracts:

- bit for bit: the ML lattice (host), the CovState carried across
  (`convert.cov_state_from`);
- equal: ML indices (the port's and JAX's), every detector's sliced
  indices at 80 dB, the spectra's peak angles;
- rel L2 <= 1e-5: steering, covariance (streamed and one-shot, loaded),
  Bartlett and MVDR spectra, the beamformed output for JAX's weights, ZF
  and MMSE estimates;
- MVDR weights within rel L2 1e-3: a solve against the covariance of a
  source 10 dB above the other and noise at -20 dB with 1e-4 loading
  (condition number 7.4e3), where torch's and XLA's LU round
  differently (measured 1.6e-4);
- MUSIC: its noise subspace compared as a projector En En^H (eigenvector
  phases are arbitrary; within 1e-4 of JAX's, measured 3.0e-7) and its
  pseudospectrum within rel L2 1e-3 (measured 4.4e-5: 1/||En^H a||^2 peaks
  where the norm nears zero, so the eigh differences of both libraries are
  amplified there).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu import array as jarr
from srcdsp_tpu import mimo as jmimo
from srcdsp_tpu.demap import psk_points
from srcdsp_tpu_torch import array as tarr
from srcdsp_tpu_torch import convert
from srcdsp_tpu_torch import mimo as tmimo
from srcdsp_tpu_torch.chains.qam import qam_constellation
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CPU = "cpu"
REL = 1e-5
GRID = np.linspace(-1.2, 1.2, 961)


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _scene(e=8, n=4096, thetas=(-0.35, 0.6), powers=(1.0, 1.0), noise=0.1, seed=0):
    rng = np.random.default_rng(seed)
    a = np.array(jarr.ula_steering(e, 0.5, jnp.asarray(thetas)))
    x = np.zeros((e, n), np.complex128)
    for s, p in enumerate(powers):
        sig = np.sqrt(p / 2) * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
        x += a[s][:, None] * sig[None, :]
    x += np.sqrt(noise / 2) * (rng.standard_normal((e, n)) + 1j * rng.standard_normal((e, n)))
    return x.astype(np.complex64), a


def _peaks(spec, grid, k):
    s = np.asarray(spec)
    loc = np.flatnonzero((s[1:-1] > s[:-2]) & (s[1:-1] > s[2:])) + 1
    return np.sort(grid[loc[np.argsort(s[loc])[::-1][:k]]])


@pytest.fixture(scope="module")
def doa():
    x, a = _scene(n=8192)
    r = jarr.sample_covariance(jnp.asarray(x), loading=1e-3)
    steer = jarr.ula_steering(8, 0.5, jnp.asarray(GRID))
    st = jarr.cov_init(8)
    states = []
    for blk in np.split(x, 4, axis=-1):
        st = jarr.cov_update(st, jnp.asarray(blk))
        states.append(st)
    _, v = jnp.linalg.eigh(r)
    en = np.asarray(v)[:, :6]
    xi, ai = _scene(thetas=(-0.35, 0.6), powers=(1.0, 10.0), n=8192, noise=0.01)
    ri = jarr.sample_covariance(jnp.asarray(xi), loading=1e-4)
    w = jarr.mvdr_weights(ri, jnp.asarray(ai[0].astype(np.complex64)))
    return dict(x=x, r=np.array(r), steer=np.array(steer), states=states,
                r_stream=np.asarray(jarr.cov_finalize(states[-1], loading=1e-3)),
                r_plain=np.asarray(jarr.sample_covariance(jnp.asarray(x))),
                bart=np.asarray(jarr.bartlett_spectrum(r, steer)),
                mvdr=np.asarray(jarr.mvdr_spectrum(r, steer)),
                music=np.asarray(jarr.music_spectrum(r, steer, 2)), proj=en @ en.conj().T,
                xi=xi, ai=ai, ri=np.array(ri), w=np.array(w),
                y=np.asarray(jarr.beamform(w, jnp.asarray(xi))))


def test_steering(doa):
    s = tarr.ula_steering(8, 0.5, GRID, device=CPU)
    assert s.dtype == torch.complex64 and rel(s.numpy(), doa["steer"]) <= REL
    a = tarr.ula_steering(8, 0.5, torch.tensor([0.0, 0.3])).numpy()
    np.testing.assert_allclose(a[0], 1.0, atol=1e-6)
    np.testing.assert_allclose(np.angle(a[1][1]), -np.pi * np.sin(0.3), atol=1e-5)
    assert tarr.ula_steering(4, 0.5, 0.1, device=CPU).shape == (1, 4)


def test_covariance_one_shot_streamed_and_handed_over(doa):
    x = doa["x"]
    r = tarr.sample_covariance(x, loading=1e-3, device=CPU)
    assert rel(r.numpy(), doa["r"]) <= REL
    assert rel(tarr.sample_covariance(torch.as_tensor(x)).numpy(), doa["r_plain"]) <= REL
    st = tarr.cov_init(8, device=CPU)
    for blk in np.split(x, 4, axis=-1):
        st = tarr.cov_update(st, blk)
    assert rel(tarr.cov_finalize(st, loading=1e-3).numpy(), doa["r_stream"]) <= REL
    jst = doa["states"]
    st = convert.cov_state_from(jst[1], device=CPU)
    np.testing.assert_array_equal(st.acc.numpy(), np.asarray(jst[1].acc))
    np.testing.assert_array_equal(st.count.numpy(), np.asarray(jst[1].count))
    for blk in np.split(x, 4, axis=-1)[2:]:
        st = tarr.cov_update(st, torch.as_tensor(blk))
    assert rel(st.acc.numpy(), np.asarray(jst[-1].acc)) <= REL
    assert float(st.count) == float(jst[-1].count)
    rb = tarr.sample_covariance(torch.as_tensor(np.stack([x[:, :1024], 2 * x[:, :1024]])))
    assert rb.shape == (2, 8, 8) and rel(rb[1].numpy(), 4 * rb[0].numpy()) <= 1e-6


def test_spectra(doa):
    r = torch.as_tensor(doa["r"])
    steer = torch.as_tensor(doa["steer"])
    bart = tarr.bartlett_spectrum(r, steer)
    mvdr = tarr.mvdr_spectrum(r, steer)
    music = tarr.music_spectrum(r, steer, 2)
    assert rel(bart.numpy(), doa["bart"]) <= REL and rel(mvdr.numpy(), doa["mvdr"]) <= REL
    en = tarr.noise_subspace(r, 2).numpy()
    assert np.abs(en @ en.conj().T - doa["proj"]).max() <= 1e-4
    assert rel(music.numpy(), doa["music"]) <= 1e-3
    for spec, want, tol in ((bart, doa["bart"], 0.05), (mvdr, doa["mvdr"], 0.01),
                            (music, doa["music"], 0.005)):
        got = _peaks(spec.numpy(), GRID, 2)
        np.testing.assert_array_equal(got, _peaks(want, GRID, 2))
        np.testing.assert_allclose(got, [-0.35, 0.6], atol=tol)


def test_music_resolves_close_pair():
    x, _ = _scene(thetas=(-0.05, 0.08), n=16384, noise=0.05)
    grid = np.linspace(-0.4, 0.4, 1601)
    r = tarr.sample_covariance(x, loading=1e-4, device=CPU)
    steer = tarr.ula_steering(8, 0.5, grid, device=CPU)
    np.testing.assert_allclose(_peaks(tarr.music_spectrum(r, steer, 2).numpy(), grid, 2),
                               [-0.05, 0.08], atol=0.01)
    bart = tarr.bartlett_spectrum(r, steer).numpy()
    assert np.flatnonzero((bart[1:-1] > bart[:-2]) & (bart[1:-1] > bart[2:])).size < 2


def test_mvdr_weights_and_beamform(doa):
    r = torch.as_tensor(doa["ri"])
    w = tarr.mvdr_weights(r, doa["ai"][0])
    assert rel(w.numpy(), doa["w"]) <= 1e-3
    g_look = abs(np.vdot(w.numpy(), doa["ai"][0]))
    g_int = abs(np.vdot(w.numpy(), doa["ai"][1]))
    assert abs(g_look - 1.0) < 1e-3 and 20 * np.log10(g_int / g_look) < -25.0
    y = tarr.beamform(torch.as_tensor(doa["w"]), doa["xi"])
    assert y.shape == (8192,) and rel(y.numpy(), doa["y"]) <= REL


def _mimo(order=4, nt=2, nr=2, n=2048, snr_db=18.0, cond=1.0, seed=0):
    rng = np.random.default_rng(seed)
    pts = np.asarray(psk_points(order)) if order in (2, 4, 8) else qam_constellation(order)
    idx = rng.integers(0, pts.size, (nt, n))
    h = (rng.standard_normal((nr, nt)) + 1j * rng.standard_normal((nr, nt))) / np.sqrt(2)
    if cond != 1.0:
        u_, sv, vt = np.linalg.svd(h)
        sv[-1] /= cond
        h = (u_ * sv) @ vt
    y = h @ pts[idx]
    sigma = np.sqrt(np.mean(np.abs(y) ** 2) / 10 ** (snr_db / 10) / 2)
    y = y + sigma * (rng.standard_normal(y.shape) + 1j * rng.standard_normal(y.shape))
    return pts, idx, h.astype(np.complex64), y.astype(np.complex64), 10 ** (snr_db / 10)


def _slice(pts, xhat):
    return np.argmin(np.abs(np.asarray(xhat)[..., None] - pts), axis=-1)


@pytest.mark.parametrize("order,nt,snr_db,cond,seed", [(16, 2, 80.0, 1.0, 0), (4, 2, 14.0, 8.0, 1),
                                                       (4, 4, 20.0, 1.0, 2), (16, 3, 25.0, 1.0, 3)])
def test_detectors_equal_reference(order, nt, snr_db, cond, seed):
    pts, idx, h, y, snr = _mimo(order=order, nt=nt, nr=nt, n=1024, snr_db=snr_db, cond=cond,
                                seed=seed)
    cands, cidx = tmimo.make_ml_lattice(pts, nt)
    jc, jci = jmimo.make_ml_lattice(pts, nt)
    np.testing.assert_array_equal(cands, jc)
    np.testing.assert_array_equal(cidx, jci)
    zf = tmimo.zf_detect(h, y, device=CPU)
    mm = tmimo.mmse_detect(h, y, snr, device=CPU)
    ml = tmimo.ml_detect(h, y, cands, cidx, device=CPU)
    assert rel(zf.numpy(), np.asarray(jmimo.zf_detect(jnp.asarray(h), jnp.asarray(y)))) <= REL
    assert rel(mm.numpy(), np.asarray(jmimo.mmse_detect(jnp.asarray(h), jnp.asarray(y), snr))) <= REL
    assert ml.dtype == torch.int32
    np.testing.assert_array_equal(ml.numpy(), np.asarray(
        jmimo.ml_detect(jnp.asarray(h), jnp.asarray(y), jc, jci)))
    if snr_db == 80.0:
        for est in (zf, mm):
            np.testing.assert_array_equal(_slice(pts, est.numpy()), idx)
        np.testing.assert_array_equal(ml.numpy(), idx)
    if cond == 8.0:
        ser = [float(np.mean(v != idx)) for v in (ml.numpy(), _slice(pts, mm.numpy()),
                                                   _slice(pts, zf.numpy()))]
        assert ser[0] <= ser[1] <= ser[2] and ser[0] < 0.5 * ser[2] and ser[2] > 0.01


def test_ml_chunks_equal_one_chunk(monkeypatch):
    pts, _, h, y, _ = _mimo(order=16, n=1000, snr_db=12.0, seed=5)
    cands, cidx = tmimo.make_ml_lattice(pts, 2)
    whole = tmimo.ml_detect(h, y, cands, cidx, device=CPU)
    monkeypatch.setattr(tmimo, "ML_CROSS", 256 * 7)
    assert torch.equal(tmimo.ml_detect(h, torch.as_tensor(y), cands, cidx), whole)


def test_per_subcarrier_ml():
    pts = np.asarray(psk_points(4))
    cands, cidx = tmimo.make_ml_lattice(pts, 2)
    rng = np.random.default_rng(2)
    hs = (rng.standard_normal((16, 2, 2)) + 1j * rng.standard_normal((16, 2, 2))).astype(np.complex64)
    idx = rng.integers(0, 4, (16, 2, 64))
    ys = np.einsum("brt,btn->brn", hs, pts[idx]).astype(np.complex64)
    got = np.stack([tmimo.ml_detect(hs[b], ys[b], cands, cidx, device=CPU).numpy()
                    for b in range(16)])
    np.testing.assert_array_equal(got, idx)
