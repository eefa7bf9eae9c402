"""Port vs JAX package: `testing.signals.chirp`, `ops/cfar` and `ops/radar`.

Fixtures (numpy, seeded): exponential (square-law) noise series [16, 4096]
with a target and a 13 dB clutter step, a matched-filter power series of the
reference's chirp test, a 32-pulse x 512-bin cube with two point targets and
an exponential [256, 512] map. The JAX side runs once per module.

Contracts:

- bit for bit: `chirp` (float64 host phase), `cfar_alpha`, `cfar_alpha_2d`,
  the detection rows of `detections` (same numpy object rows);
- thresholds within a relative tolerance per cell: the training sums are
  differences of float32 running sums (an integral image in 2-D), which
  `torch.cumsum` and XLA add in different orders, so the gap grows with the
  running sum against the window sum (a 64-cell series is held with a
  4-cell window, the 4096-cell ones with 16-cell windows). Measured on these
  fixtures: 1-D at most 6.7e-5 of the threshold (rel L2 6.2e-6), held at
  2e-4; 2-D at most 4.5e-4 on the noise map (the integral image's entries
  reach the map's total, 1.3e5 at 256 x 512, whose float32 ulp is 0.0078
  against ring sums near 72) and 1.7e-3 on the target cube (its two targets'
  peaks raise the total), held at 5e-3;
- masks equal except on cells whose power lies within that tolerance of the
  threshold; those cells are counted and must be very few: at most 1e-4 of
  the cells (none on the 1-D fixtures at 2e-4 and none on the target cube;
  8 of 131,072 on the noise map at 5e-3);
- rel L2 <= 1e-5: the matched filter and the range-Doppler map (FFTs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu.ops import cfar as jcfar
from srcdsp_tpu.ops import radar as jradar
from srcdsp_tpu.testing import signals as jsig
from srcdsp_tpu_torch.ops import cfar as tcfar
from srcdsp_tpu_torch.ops import radar as tradar
from srcdsp_tpu_torch.testing import signals as tsig
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CPU = "cpu"
TOL_1D, TOL_2D = 2e-4, 5e-3


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _exp_noise(rng, shape, scale=1.0):
    z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return scale * 0.5 * np.abs(z) ** 2


def _masks_agree(mask, mask_ref, power, thr_ref, tol):
    """Masks equal away from the threshold; returns the cells within `tol`
    of it (where float rounding may decide either way)."""
    mask, mask_ref = np.asarray(mask), np.asarray(mask_ref)
    near = np.abs(np.asarray(power) - np.asarray(thr_ref)) <= tol * np.abs(np.asarray(thr_ref))
    assert np.array_equal(mask[~near], mask_ref[~near])
    assert near.sum() <= max(2, 1e-4 * near.size)
    return int(near.sum())


@pytest.fixture(scope="module")
def series():
    rng = np.random.default_rng(0)
    p = _exp_noise(rng, (16, 4096), scale=3.7)
    p[3, 700] += 80.0
    p[5] = np.concatenate([_exp_noise(rng, 2048), _exp_noise(rng, 2048, 20.0)])
    p = p.astype(np.float32)
    ref = {}
    for name, kw in (("ca_cfar", dict(guard=2, train=16, pfa=1e-2)),
                     ("go_cfar_split", dict(guard=2, train=16, pfa=1e-3)),
                     ("ca_cfar_small", dict(guard=0, train=4, pfa=1e-1))):
        fn = getattr(jcfar, name.replace("_small", ""))
        det, thr = fn(jnp.asarray(p[:, :64] if "small" in name else p), **kw)
        ref[name] = (kw, np.asarray(det), np.asarray(thr))
    return p, ref


@pytest.fixture(scope="module")
def cube():
    rng = np.random.default_rng(1)
    p, n = 32, 512
    ref = jsig.chirp(64, -0.2, 0.2)
    c = np.zeros((p, n), np.complex64)
    for delay, fd, amp in ((137, 5.0 / p, 1.0), (300, -9.0 / p, 0.7)):
        for k in range(p):
            c[k, delay: delay + ref.size] += amp * ref * np.exp(2j * np.pi * fd * k)
    c = (c + 0.1 * (rng.standard_normal(c.shape) + 1j * rng.standard_normal(c.shape))
         ).astype(np.complex64)
    mf = np.asarray(jradar.pulse_compress(jnp.asarray(c), jnp.asarray(ref)))
    rd = np.asarray(jradar.range_doppler(jnp.asarray(c), jnp.asarray(ref)))
    rect = np.asarray(jradar.range_doppler(jnp.asarray(c), jnp.asarray(ref), window="rect"))
    pw = (np.abs(rd) ** 2).astype(np.float32)
    mask, thr = jradar.cfar_2d(jnp.asarray(pw), guard=2, train=4, pfa=1e-6)
    noise = rng.exponential(1.0, (256, 512)).astype(np.float32)
    nmask, nthr = jradar.cfar_2d(jnp.asarray(noise), guard=1, train=4, pfa=1e-3)
    return dict(c=c, ref=ref, mf=mf, rd=rd, rect=rect, pw=pw, mask=np.asarray(mask),
                thr=np.asarray(thr), dets=jradar.detections(pw, np.asarray(mask)),
                noise=noise, nmask=np.asarray(nmask), nthr=np.asarray(nthr))


@pytest.mark.parametrize("n,f0,f1,amp", [(64, -0.2, 0.2, 1.0), (1024, -0.2, 0.2, 1.0),
                                         (512, 0.1, -0.3, 0.5), (8191, 0.0, 0.45, 2.0)])
def test_chirp_bit_for_bit(n, f0, f1, amp):
    np.testing.assert_array_equal(tsig.chirp(n, f0, f1, amp), jsig.chirp(n, f0, f1, amp))


@pytest.mark.parametrize("t,pfa", [(1, 0.1), (16, 1e-3), (32, 1e-6), (81, 1e-4)])
def test_alphas_equal(t, pfa):
    assert tcfar.cfar_alpha(t, pfa) == jcfar.cfar_alpha(t, pfa)
    assert tradar.cfar_alpha_2d(t, pfa) == jradar.cfar_alpha_2d(t, pfa)


@pytest.mark.parametrize("name", ["ca_cfar", "go_cfar_split", "ca_cfar_small"])
def test_cfar_thresholds_and_masks(series, name):
    p, ref = series
    kw, det_j, thr_j = ref[name]
    p = p[:, :64] if "small" in name else p
    fn = getattr(tcfar, name.replace("_small", ""))
    det, thr = fn(p, device=CPU, **kw)
    assert det.dtype == torch.bool and thr.dtype == torch.float32
    assert float(np.max(np.abs(thr.numpy() - thr_j) / thr_j)) <= TOL_1D
    assert rel(thr.numpy(), thr_j) <= 1e-5
    _masks_agree(det.numpy(), det_j, p, thr_j, TOL_1D)
    if name == "ca_cfar":
        assert det[3, 700]


def test_cfar_tensor_stays_and_rejects_short():
    p = torch.ones(2, 40)
    det, thr = tcfar.ca_cfar(p, guard=2, train=16)
    assert det.device == p.device and not det.any()
    with pytest.raises(ValueError, match="guard\\+train\\+1"):
        tcfar.ca_cfar(torch.ones(18), guard=2, train=16)


def test_cfar_on_matched_filter_power():
    """The reference's chirp test: the compressed pulse's |score|^2 through
    CA-CFAR (guard 4, train 32, pfa 1e-5) gives the reference's mask."""
    n = 1024
    pulse = jsig.chirp(n, -0.2, 0.2)
    rng = np.random.default_rng(0)
    cap = (1.5 * (rng.standard_normal(8192) + 1j * rng.standard_normal(8192))).astype(np.complex64)
    cap[3000:3000 + n] += pulse
    sc = (np.abs(np.correlate(cap, pulse, mode="valid")) / n) ** 2
    sc = sc.astype(np.float32)
    dj, tj = jcfar.ca_cfar(jnp.asarray(sc), guard=4, train=32, pfa=1e-5)
    dt, tt = tcfar.ca_cfar(sc, guard=4, train=32, pfa=1e-5, device=CPU)
    assert _masks_agree(dt.numpy(), np.asarray(dj), sc, np.asarray(tj), TOL_1D) == 0
    assert dt[3000] and bool(np.asarray(dj)[3000])


def test_pulse_compress_and_range_doppler(cube):
    mf = tradar.pulse_compress(cube["c"], cube["ref"], device=CPU)
    assert rel(mf.numpy(), cube["mf"]) <= 1e-5
    rd = tradar.range_doppler(cube["c"], cube["ref"], device=CPU)
    assert rd.dtype == torch.complex64 and rel(rd.numpy(), cube["rd"]) <= 1e-5
    rect = tradar.range_doppler(torch.as_tensor(cube["c"]), cube["ref"], window="rect")
    assert rel(rect.numpy(), cube["rect"]) <= 1e-5
    with pytest.raises(ValueError, match="window"):
        tradar.range_doppler(cube["c"], cube["ref"], window="kaiser", device=CPU)


def test_cfar_2d_and_detections(cube):
    mask, thr = tradar.cfar_2d(cube["pw"], guard=2, train=4, pfa=1e-6, device=CPU)
    assert float(np.max(np.abs(thr.numpy() - cube["thr"]) / cube["thr"])) <= TOL_2D
    _masks_agree(mask.numpy(), cube["mask"], cube["pw"], cube["thr"], TOL_2D)
    dets = tradar.detections(torch.as_tensor(cube["pw"]), mask)
    assert dets.dtype == object and dets.shape == cube["dets"].shape
    assert [tuple(r) for r in dets] == [tuple(r) for r in cube["dets"]]
    assert (dets[0][0], dets[0][1]) == (16 + 5, 137)
    assert (16 - 9, 300) in [(r[0], r[1]) for r in dets]


def test_cfar_2d_noise_map_and_pfa(cube):
    mask, thr = tradar.cfar_2d(torch.as_tensor(cube["noise"]), guard=1, train=4, pfa=1e-3)
    assert float(np.max(np.abs(thr.numpy() - cube["nthr"]) / cube["nthr"])) <= TOL_2D
    _masks_agree(mask.numpy(), cube["nmask"], cube["noise"], cube["nthr"], TOL_2D)
    assert 0.3e-3 < float(mask.float().mean()) < 3e-3


def test_cfar_2d_ring_matches_loop_twin():
    """The reference's loop twin at the corners and an edge: the ring mean
    of the reflect-padded map (the edge cell not repeated)."""
    rng = np.random.default_rng(1)
    pw = rng.exponential(1.0, (24, 40)).astype(np.float32)
    guard, train = 1, 3
    _, thr = tradar.cfar_2d(pw, guard=guard, train=train, pfa=1e-3, device=CPU)
    ho = guard + train
    n_train = (2 * ho + 1) ** 2 - (2 * guard + 1) ** 2
    alpha = tradar.cfar_alpha_2d(n_train, 1e-3)
    pad = np.pad(pw, ho, mode="reflect")
    for a, b in [(0, 0), (5, 7), (23, 39), (12, 0)]:
        box = pad[a: a + 2 * ho + 1, b: b + 2 * ho + 1]
        inner = pad[a + train: a + train + 2 * guard + 1, b + train: b + train + 2 * guard + 1]
        np.testing.assert_allclose(float(thr[a, b]), alpha * (box.sum() - inner.sum()) / n_train,
                                   rtol=2e-5)
