"""Port vs JAX package: `ops/cyclo` (FAM spectral correlation) and
`ops/accel` (acceleration search).

Fixtures (seeded): the reference test's RRC-shaped BPSK and QPSK (sps 8,
beta 0.35, 4,096 symbols; BPSK also at carrier 0.12, both drawn and shaped
by the JAX package), numpy white noise, a tone at 0.2; drifting
tones at N 8,192 (-12 dB, 100 bins of drift, the reference test's) and 4,096.
The JAX side runs once per module.

Contracts:

- bit for bit: `_frames` (both forms: reshape when hop divides Np, gather
  otherwise), the (f, alpha) grids (host float64, cast to float32), the
  profile's alpha axis, the accel drift grid and the dechirp phasors (the
  float64 phase r*n^2/2 mod 1 formed in torch equals numpy's, and its
  complex64 exponential too);
- rel L2 <= 1e-5: the SCF (two FFTs and a product), the cycle profile
  (its per-bin maximum is order-free, so the gap is the SCF's), the accel
  metric;
- equal: the detected cycles (the same alphas, each strength within 1e-5
  relative; the list is sorted by strength, and a +-alpha pair of equal
  strength may come in either order), the accel peak cell; the refined freq and drift within 1e-9
  cycles/sample (a parabolic fit on float32 magnitudes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu.ops import accel as jacc
from srcdsp_tpu.ops import cyclo as jcy
from srcdsp_tpu_torch.ops import accel as tacc
from srcdsp_tpu_torch.ops import cyclo as tcy
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CPU = "cpu"
REL = 1e-5


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _sig(order, nsym, sps, fc, key):
    """The reference test's fixture (tests/unit/test_cyclo.py): JAX-drawn
    symbols, RRC-shaped by the JAX resampler, mixed to fc."""
    import jax

    from srcdsp_tpu.ops.resample import resample_full
    from srcdsp_tpu.ops.window import root_raised_cosine
    from srcdsp_tpu.testing.signals import tone

    data = np.asarray(jax.random.randint(jax.random.PRNGKey(key), (nsym,), 0, order))
    if order == 2:
        sym = (2.0 * data - 1.0).astype(np.complex64)
    else:
        sym = np.exp(2j * np.pi * (data + 0.5) / order).astype(np.complex64)
    taps = root_raised_cosine(sps, 8, beta=0.35)
    x = np.asarray(resample_full(jnp.asarray(taps), jnp.asarray(sym), up=sps, down=1))
    return (x * np.asarray(tone(len(x), fc))).astype(np.complex64)


@pytest.fixture(scope="module")
def scf():
    rng = np.random.default_rng(0)
    noise = ((rng.standard_normal(32768) + 1j * rng.standard_normal(32768)) / np.sqrt(2)
             ).astype(np.complex64)
    sigs = {
        "bpsk_baud": (_sig(2, 4096, 8, 0.0, 0) + 0.3 * noise[:32775], dict(np_=64, p=256)),
        "bpsk_conj": (_sig(2, 4096, 8, 0.12, 1), dict(np_=64, p=256, conj=True)),
        "qpsk_conj": (_sig(4, 4096, 8, 0.12, 2), dict(np_=64, p=256, conj=True)),
        "noise": (noise, dict(np_=64, p=256)),
        "tone_hann": (np.exp(2j * np.pi * 0.2 * np.arange(8192)).astype(np.complex64),
                      dict(np_=64, p=128, window="hann")),
        "rect_48": (noise[:8192], dict(np_=48, p=64, window="rect")),
    }
    out = {}
    for name, (x, kw) in sigs.items():
        r = jcy.fam_scf(jnp.asarray(x), **kw)
        axis, prof = jcy.cycle_profile(r, normalize=name != "qpsk_conj")
        out[name] = dict(x=x, kw=kw, r=r, axis=np.asarray(axis), prof=np.asarray(prof),
                         peaks=jcy.detect_cycles(r, thresh=0.35))
    return out


@pytest.mark.parametrize("np_,hop,p", [(64, 16, 32), (48, 12, 20), (64, 24, 16), (50, 7, 9)])
def test_frames_bit_for_bit(np_, hop, p):
    x = np.random.default_rng(np_ + hop).standard_normal(3000).astype(np.float32)
    got = tcy._frames(torch.as_tensor(x), np_, hop, p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jcy._frames(jnp.asarray(x), np_, hop, p)))
    with pytest.raises(ValueError, match="need"):
        tcy._frames(torch.zeros(100), 64, 16, 128)


@pytest.mark.parametrize("name", ["bpsk_baud", "bpsk_conj", "qpsk_conj", "noise", "tone_hann",
                                  "rect_48"])
def test_fam_scf_and_profile(scf, name):
    c = scf[name]
    r = tcy.fam_scf(c["x"], device=CPU, **c["kw"])
    assert r.scf.dtype == torch.complex64 and r.scf.shape == tuple(c["r"].scf.shape)
    assert rel(r.scf.numpy(), np.asarray(c["r"].scf)) <= REL
    np.testing.assert_array_equal(r.freq.numpy(), np.asarray(c["r"].freq))
    np.testing.assert_array_equal(r.alpha.numpy(), np.asarray(c["r"].alpha))
    axis, prof = tcy.cycle_profile(r, normalize=name != "qpsk_conj")
    np.testing.assert_array_equal(axis.numpy(), c["axis"])
    assert rel(prof.numpy(), c["prof"]) <= REL
    peaks = dict(tcy.detect_cycles(r, thresh=0.35))
    want = dict(c["peaks"])
    assert sorted(peaks) == sorted(want)
    for a, s in peaks.items():
        assert abs(s - want[a]) <= REL * want[a]


def test_cycle_features(scf):
    """The reference tests' physics on the port's own SCF: the baud line of
    BPSK, none in noise, the conjugate 2 fc line of BPSK and no such line of
    QPSK (> 4x apart), the tone's PSD channel."""
    peaks = tcy.detect_cycles(tcy.fam_scf(scf["bpsk_baud"]["x"], 64, 256, device=CPU))
    assert min(abs(abs(a) - 1 / 8) for a, _ in peaks) < 2e-3
    assert not tcy.detect_cycles(tcy.fam_scf(scf["noise"]["x"], 64, 256, device=CPU))
    rb = tcy.fam_scf(scf["bpsk_conj"]["x"], 64, 256, conj=True, device=CPU)
    rq = tcy.fam_scf(scf["qpsk_conj"]["x"], 64, 256, conj=True, device=CPU)
    assert min(abs(a - 0.24) for a, _ in tcy.detect_cycles(rb)) < 2e-3
    assert float(tcy.cycle_profile(rb, normalize=False)[1].max()) > 4.0 * float(
        tcy.cycle_profile(rq, normalize=False)[1].max())
    r = tcy.fam_scf(scf["tone_hann"]["x"], 64, 128, device=CPU)
    diag = np.diagonal(np.abs(r.scf.numpy())[:, :, 64])
    assert abs(np.diagonal(r.freq.numpy())[int(diag.argmax())] - 0.2) < 1 / 64


def _drifting(n, f0, r, snr_db, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64)
    x = np.exp(2j * np.pi * (f0 * t + 0.5 * r * t * t))
    sigma = np.sqrt(10 ** (-snr_db / 10) / 2)
    return (x + sigma * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)


@pytest.mark.parametrize("n,max_drift", [(8192, 120.0), (4096, 8.0), (1000, 3.0)])
def test_accel_grid_and_phasors_bit_for_bit(n, max_drift):
    rates = tacc.accel_grid(n, max_drift / (n * n))
    np.testing.assert_array_equal(rates, jacc.accel_grid(n, max_drift / (n * n)))
    idx = np.arange(n, dtype=np.float64)
    fr = np.mod(rates[:, None] * (idx * idx)[None, :] / 2.0, 1.0)
    want = np.exp(-2j * np.pi * fr).astype(np.complex64)
    np.testing.assert_array_equal(tacc.dechirp_phasors(rates, n, CPU).numpy(), want)


@pytest.mark.parametrize("case", ["drift_100_bins", "zero_drift", "noise"])
def test_accel_search(case):
    n = 8192 if case == "drift_100_bins" else 4096
    if case == "drift_100_bins":
        x, md = _drifting(n, 0.123, 100.0 / (n * n), -12.0, 0), 120.0 / (n * n)
    elif case == "zero_drift":
        x, md = _drifting(n, -0.2, 0.0, 0.0, 1), 8.0 / (n * n)
    else:
        rng = np.random.default_rng(2)
        x, md = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64), \
            8.0 / (n * n)
    want = jacc.accel_search(x, max_drift=md)
    got = tacc.accel_search(x, max_drift=md, device=CPU)
    assert isinstance(got.metric, np.ndarray) and got.metric.shape == want.metric.shape
    assert rel(got.metric, want.metric) <= REL
    np.testing.assert_array_equal(got.rates, want.rates)
    assert np.unravel_index(np.argmax(got.metric), got.metric.shape) == \
        np.unravel_index(np.argmax(want.metric), want.metric.shape)
    assert abs(got.freq - want.freq) <= 1e-9 and abs(got.drift - want.drift) <= 1e-9 / n
    assert abs(got.ratio - want.ratio) <= REL * want.ratio
    if case == "drift_100_bins":
        assert abs(got.freq - 0.123) < 1.0 / n and abs(got.drift - 100.0 / n ** 2) < 0.5 / n ** 2
        assert got.ratio > 18
    elif case == "noise":
        assert got.ratio < 8.0
    with pytest.raises(ValueError, match="rates or max_drift"):
        tacc.accel_search(x, device=CPU)
