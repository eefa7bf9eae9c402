"""Port vs JAX package: `ops/impairments` (moments, IQ imbalance, DC, CFO,
SNR, impulse blanking).

Fixtures (numpy, seeded): circular Gaussian blocks (one channel of 2^14 and
two of 8,192) with gain/skew imbalance, one with a DC offset, tones in light noise
for the CFO estimators, QPSK and 16-QAM blocks for M2M4, and a QPSK stream
with strong sparse impulses for the blanker. The JAX side runs once per
module.

Contracts:

- estimates (gain, skew, DC, CFO, SNR) and corrected/impaired IQ within rel
  L2 1e-5 of the JAX package's; the moments are float32 sums, which torch
  and XLA reduce in different orders;
- the FFT-peak bin (integer) equal, and every estimate within the
  reference tests' bounds of the truth;
- streaming the moments in 8 blocks equals the one-shot run to float32
  rounding (rel 1e-5); a JAX MomentState handed to the port after 4 blocks
  (`convert.moment_state_from`) finishes to the JAX stream's estimates;
- the blanker's mask equal to the reference's away from the CFAR threshold
  (`ops.cfar`'s contract: cells within 2e-4 of it counted, none here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu.ops import impairments as jimp
from srcdsp_tpu_torch import convert
from srcdsp_tpu_torch.ops import impairments as timp
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CPU = "cpu"
REL = 1e-5


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _circular(n, seed):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal(n) + 1j * rng.standard_normal(n)) / np.sqrt(2)).astype(np.complex64)


@pytest.fixture(scope="module")
def iq():
    y = _circular(1 << 14, 1)
    bad = np.array(jimp.iq_imbalance_apply(jnp.asarray(y), 1.12, 0.07))
    dcy = _circular(1 << 14, 3) + np.complex64(0.05 - 0.02j)
    two = np.stack([_circular(8192, 8), _circular(8192, 9)])
    bad2 = np.array(jimp.iq_imbalance_apply(jnp.asarray(two), 1.1, 0.08))
    g, phi = jimp.iq_imbalance_estimate(bad)
    g2, phi2 = jimp.iq_imbalance_estimate(bad2)
    st = jimp.moments_init()
    upd = jax.jit(jimp.moments_update)
    states = []
    for blk in np.split(bad, 8):
        st = upd(st, jnp.asarray(blk))
        states.append(st)
    return dict(y=y, bad=bad, g=float(g), phi=float(phi),
                fixed=np.asarray(jimp.iq_imbalance_correct(bad, g, phi)),
                bad2=bad2, g2=np.asarray(g2), phi2=np.asarray(phi2),
                fixed2=np.asarray(jimp.iq_imbalance_correct(bad2, g2, phi2)),
                dcy=dcy, dc=complex(jimp.dc_offset(dcy)), snr=float(jimp.snr_m2m4(bad)),
                states=states, stream=jimp.iq_imbalance_estimate(states[-1]))


def test_apply_estimate_correct(iq):
    bad = timp.iq_imbalance_apply(iq["y"], 1.12, 0.07, device=CPU)
    assert rel(bad.numpy(), iq["bad"]) <= REL
    g, phi = timp.iq_imbalance_estimate(iq["bad"], device=CPU)
    assert abs(float(g) - iq["g"]) <= REL * iq["g"] and abs(float(phi) - iq["phi"]) <= REL
    assert abs(float(g) - 1.12) < 0.01 and abs(float(phi) - 0.07) < 0.005
    fixed = timp.iq_imbalance_correct(torch.as_tensor(iq["bad"]), g, phi)
    assert fixed.dtype == torch.complex64 and rel(fixed.numpy(), iq["fixed"]) <= REL
    assert abs(complex((fixed - fixed.mean()).pow(2).mean())) < 0.005


def test_multichannel(iq):
    g, phi = timp.iq_imbalance_estimate(torch.as_tensor(iq["bad2"]))
    assert g.shape == (2,) and phi.shape == (2,)
    assert rel(g.numpy(), iq["g2"]) <= REL and rel(phi.numpy(), iq["phi2"]) <= REL
    fixed = timp.iq_imbalance_correct(torch.as_tensor(iq["bad2"]), g, phi)
    assert rel(fixed.numpy(), iq["fixed2"]) <= REL
    assert np.all(np.abs((fixed ** 2).mean(dim=-1).numpy()) < 0.01)


def test_dc_and_snr_one_shot(iq):
    dc = timp.dc_offset(iq["dcy"], device=CPU)
    assert dc.dtype == torch.complex64
    assert abs(complex(dc) - iq["dc"]) <= REL * abs(iq["dc"])
    assert abs(complex(dc) - (0.05 - 0.02j)) < 0.01
    assert abs(float(timp.snr_m2m4(iq["bad"], device=CPU)) - iq["snr"]) <= REL * iq["snr"]


def test_moments_streaming_and_jax_state_hand_over(iq):
    """8 blocks streamed == the one-shot estimate; the JAX stream's state
    after 4 blocks, converted, finishes to the JAX stream's final state."""
    blocks = np.split(iq["bad"], 8)
    st = timp.moments_init(device=CPU)
    for blk in blocks:
        st = timp.moments_update(st, torch.as_tensor(blk))
    g_s, phi_s = timp.iq_imbalance_estimate(st)
    g_o, phi_o = timp.iq_imbalance_estimate(torch.as_tensor(iq["bad"]))
    assert abs(float(g_s) - float(g_o)) <= REL and abs(float(phi_s) - float(phi_o)) <= 1e-6
    jst = iq["states"]
    st = convert.moment_state_from(jst[3], device=CPU)
    for f in st._fields:
        np.testing.assert_array_equal(getattr(st, f).numpy(), np.asarray(getattr(jst[3], f)))
    for blk in blocks[4:]:
        st = timp.moments_update(st, torch.as_tensor(blk))
    for f in st._fields:
        assert rel(getattr(st, f).numpy(), np.asarray(getattr(jst[-1], f))) <= REL, f
    g, phi = timp.iq_imbalance_estimate(st)
    assert abs(float(g) - float(iq["stream"][0])) <= REL
    assert abs(float(phi) - float(iq["stream"][1])) <= 1e-6


def test_image_rejection_on_tone():
    n = 1 << 14
    y = np.exp(2j * np.pi * 0.123 * np.arange(n)).astype(np.complex64)
    bad_j = jimp.iq_imbalance_apply(jnp.asarray(y), 1.1, 0.1)
    fixed_j = np.asarray(jimp.iq_imbalance_correct(bad_j, *jimp.iq_imbalance_estimate(bad_j)))
    bad = timp.iq_imbalance_apply(y, 1.1, 0.1, device=CPU)
    fixed = timp.iq_imbalance_correct(bad, *timp.iq_imbalance_estimate(bad))
    assert rel(fixed.numpy(), fixed_j) <= REL
    spec = np.abs(np.fft.fft(fixed.numpy()))
    pk = int(round(0.123 * n))
    assert 20 * np.log10(spec[n - pk] / spec[pk]) < -40.0


@pytest.mark.parametrize("f0", [0.001, 0.0304, -0.2, 0.437])
def test_cfo_kay(f0):
    n = 4096
    rng = np.random.default_rng(4)
    y = (np.exp(2j * np.pi * f0 * np.arange(n))
         + 0.02 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)
    want = float(jimp.cfo_kay(jnp.asarray(y)))
    got = timp.cfo_kay(y, device=CPU)
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= REL * abs(want) and abs(float(got) - f0) < 1e-4


@pytest.mark.parametrize("f0,n,nfft", [(100.37 / 4096, 4096, None), (-0.17, 2048, None),
                                       (0.2496, 1000, 4096), (-0.5, 512, None)])
def test_cfo_fft_peak(f0, n, nfft):
    rng = np.random.default_rng(5)
    y = (np.exp(2j * np.pi * f0 * np.arange(n))
         + 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)
    want = float(jimp.cfo_fft_peak(jnp.asarray(y), nfft))
    got = float(timp.cfo_fft_peak(y, nfft, device=CPU))
    m = nfft or n
    assert round((got % 1.0) * m) % m == round((want % 1.0) * m) % m     # the same peak bin
    assert abs(got - want) <= 1e-5
    assert abs((got - f0 + 0.5) % 1.0 - 0.5) < 0.25 / m + 1e-3


@pytest.mark.parametrize("order,snr_db", [(4, 5.0), (4, 20.0), (16, 15.0)])
def test_snr_m2m4(order, snr_db):
    from srcdsp_tpu_torch.chains.qam import qam_constellation

    n = 1 << 16
    rng = np.random.default_rng(6)
    if order == 4:
        s, ka = np.exp(1j * (np.pi / 4 + np.pi / 2 * rng.integers(0, 4, n))), 1.0
    else:
        const = qam_constellation(16)
        s = const[rng.integers(0, 16, n)]
        ka = float(np.mean(np.abs(const) ** 4) / np.mean(np.abs(const) ** 2) ** 2)
    npow = 10 ** (-snr_db / 10)
    y = (s + np.sqrt(npow / 2) * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
         ).astype(np.complex64)
    want = float(jimp.snr_m2m4(jnp.asarray(y), kurtosis_signal=ka))
    got = float(timp.snr_m2m4(y, kurtosis_signal=ka, device=CPU))
    assert abs(got - want) <= REL * want
    assert abs(10 * np.log10(got) - snr_db) < 1.0
    with pytest.raises(ValueError, match="kurtosis"):
        timp.snr_m2m4(y, kurtosis_signal=2.0, device=CPU)


def test_blank_impulses_mask_and_cleaned():
    rng = np.random.default_rng(0)
    sym = np.exp(2j * np.pi * (rng.integers(0, 4, 1024) + 0.5) / 4)
    x = np.repeat(sym, 4)
    pos = rng.choice(x.size, 40, replace=False)
    x[pos] += 30.0 * np.exp(2j * np.pi * rng.random(40))
    x = x.astype(np.complex64)
    cj, mj = jimp.blank_impulses(jnp.asarray(x))
    c, m = timp.blank_impulses(x, device=CPU)
    p = (np.abs(x) ** 2).astype(np.float32)
    from srcdsp_tpu.ops.cfar import ca_cfar
    _, thr = ca_cfar(jnp.asarray(p), guard=2, train=32, pfa=1e-4)
    near = np.abs(p - np.asarray(thr)) <= 2e-4 * np.asarray(thr)
    assert near.sum() == 0
    assert np.array_equal(m.numpy(), np.asarray(mj))
    assert np.array_equal(c.numpy(), np.asarray(cj))
    assert 40 <= int(m.sum()) <= 120 and set(pos) <= set(np.flatnonzero(m.numpy()))
