"""Front-end impairment estimation and correction (counterpart of
``srcdsp_tpu/ops/impairments.py``).

- **IQ imbalance**: model Q = g (cos(phi) Q' + sin(phi) I') against the
  reference rail I; blind estimation from circularity statistics (Moseley &
  Slump): g sin(phi) = E[IQ]/E[I^2], g^2 = E[Q^2]/E[I^2]; correction is a
  constant 2x2 real matrix on (I, Q).
- **DC offset**: the complex mean (exact running average via the moments).
- **CFO**: Kay's weighted phase-difference estimator and an FFT-peak coarse
  estimator with 3-point parabolic interpolation on log magnitudes.
- **SNR**: the blind M2M4 moments method.
- **Impulse blanking**: CA-CFAR on |x|^2 zeroes samples far above the local
  power floor.

Every estimator runs on its input's device from a `MomentState` (n, sums of
y, I^2, Q^2, IQ, |y|^2 and |y|^4), streamed block by block with
`moments_update` or built from one block; a non-tensor block goes to
`device` (None = the card). The sums are float32 reductions, so a streamed
state equals the one-shot state to float32 rounding, as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from srcdsp_tpu_torch.device import as_tensor_on, resolve
from srcdsp_tpu_torch.ops.cfar import ca_cfar
from srcdsp_tpu_torch.types import CF32, F32

__all__ = [
    "MomentState", "moments_init", "moments_update",
    "iq_imbalance_estimate", "iq_imbalance_correct", "iq_imbalance_apply",
    "dc_offset", "cfo_kay", "cfo_fft_peak", "snr_m2m4",
]


# ---------- streaming second/fourth-moment accumulator ----------

class MomentState(NamedTuple):
    """Running sums: n, sum(y), sum(I^2), sum(Q^2), sum(I*Q), sum(|y|^2),
    sum(|y|^4), enough to finalize every estimator in this module."""

    n: torch.Tensor       # [] f32 sample count
    s1: torch.Tensor      # [...] c64 sum of y
    sii: torch.Tensor     # [...] f32
    sqq: torch.Tensor     # [...] f32
    siq: torch.Tensor     # [...] f32
    sm2: torch.Tensor     # [...] f32 sum |y|^2
    sm4: torch.Tensor     # [...] f32 sum |y|^4


def moments_init(channel_shape: tuple = (), device=None) -> MomentState:
    dev = resolve(device)
    z = torch.zeros(channel_shape, dtype=F32, device=dev)
    return MomentState(n=torch.zeros((), dtype=F32, device=dev),
                       s1=torch.zeros(channel_shape, dtype=CF32, device=dev),
                       sii=z, sqq=z, siq=z, sm2=z, sm4=z)


def moments_update(state: MomentState, y: torch.Tensor) -> MomentState:
    i, q = y.real.to(F32), y.imag.to(F32)
    m2 = i * i + q * q
    return MomentState(
        n=state.n + np.float32(y.shape[-1]),
        s1=state.s1 + y.sum(dim=-1),
        sii=state.sii + (i * i).sum(dim=-1),
        sqq=state.sqq + (q * q).sum(dim=-1),
        siq=state.siq + (i * q).sum(dim=-1),
        sm2=state.sm2 + m2.sum(dim=-1),
        sm4=state.sm4 + (m2 * m2).sum(dim=-1))


def _moments(state_or_y, device) -> MomentState:
    if isinstance(state_or_y, MomentState):
        return state_or_y
    y = as_tensor_on(state_or_y, device)
    return moments_update(moments_init(tuple(y.shape[:-1]), device=y.device), y)


# ---------- IQ imbalance ----------

def iq_imbalance_estimate(state_or_y, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (gain g, quadrature skew phi in radians) from a MomentState or a
    raw block (the Moseley-Slump blind estimator; it assumes a circular
    input, so calibrate on a wideband or noise block, as the reference's
    docstring measures)."""
    st = _moments(state_or_y, device)
    eii = st.sii / st.n
    eqq = st.sqq / st.n
    eiq = st.siq / st.n
    sin_phi_g = eiq / eii                       # = g sin(phi)
    g = torch.sqrt(eqq / eii)                   # g^2 = E[Q^2]/E[I^2]
    sin_phi = torch.clamp(sin_phi_g / g, -0.999, 0.999)
    return g.to(F32), torch.arcsin(sin_phi).to(F32)


def _per_stream(v, like: torch.Tensor) -> torch.Tensor:
    """A per-stream parameter broadcast over the samples' axis."""
    t = torch.as_tensor(v, dtype=F32, device=like.device)
    return t[..., None] if t.ndim else t


def iq_imbalance_correct(y: torch.Tensor, g, phi) -> torch.Tensor:
    """Invert the imbalance: I' = I, Q' = (Q / g - I sin phi) / cos phi."""
    i, q = y.real.to(F32), y.imag.to(F32)
    g, phi = _per_stream(g, y), _per_stream(phi, y)
    qp = (q / g - i * torch.sin(phi)) / torch.cos(phi)
    return torch.complex(i, qp)


def iq_imbalance_apply(y, g: float, phi: float, device=None) -> torch.Tensor:
    """Impairment injector (test fixture): apply gain/skew to clean IQ."""
    y = as_tensor_on(y, device)
    i, q = y.real.to(F32), y.imag.to(F32)
    ph = torch.tensor(phi, dtype=F32, device=y.device)
    q2 = np.float32(g) * (torch.cos(ph) * q + torch.sin(ph) * i)
    return torch.complex(i, q2)


# ---------- DC offset ----------

def dc_offset(state_or_y, device=None) -> torch.Tensor:
    """Complex mean (exact running average via MomentState, or one-shot)."""
    st = _moments(state_or_y, device)
    return (st.s1 / st.n).to(CF32)


# ---------- CFO ----------

def cfo_kay(y, device=None) -> torch.Tensor:
    """Kay's estimator: frequency in cycles/sample of a noisy tone, the
    parabolic-window weighted average of successive phase differences."""
    y = as_tensor_on(y, device)
    d = y[..., 1:] * torch.conj(y[..., :-1])
    n = d.shape[-1]
    k = torch.arange(n, dtype=F32, device=y.device)
    w = np.float32(1.5 * n / (n * n - 1.0)) * (
        1.0 - ((k - np.float32((n - 1) / 2)) / np.float32(n / 2)) ** 2)
    ang = torch.angle(d).to(F32)
    return ((w * ang).sum(dim=-1) / np.float32(2.0 * np.pi)).to(F32)


def cfo_fft_peak(y, nfft: int | None = None, device=None) -> torch.Tensor:
    """Coarse tone frequency: FFT magnitude argmax + 3-point parabolic
    interpolation (log magnitude) -> cycles/sample in [-0.5, 0.5)."""
    y = as_tensor_on(y, device)
    nfft = nfft or y.shape[-1]
    spec = torch.fft.fft(y, n=nfft, dim=-1)
    mag = torch.abs(spec) + np.float32(1e-30)
    k0 = torch.argmax(mag, dim=-1)
    km = torch.remainder(k0 - 1, nfft)
    kp = torch.remainder(k0 + 1, nfft)
    lm = torch.log(torch.gather(mag, -1, km[..., None]))[..., 0]
    l0 = torch.log(torch.gather(mag, -1, k0[..., None]))[..., 0]
    lp = torch.log(torch.gather(mag, -1, kp[..., None]))[..., 0]
    delta = 0.5 * (lm - lp) / (lm - 2.0 * l0 + lp)
    f = (k0.to(F32) + delta) / np.float32(nfft)
    return torch.where(f >= 0.5, f - 1.0, f).to(F32)


# ---------- SNR ----------

def snr_m2m4(state_or_y, kurtosis_signal: float = 1.0, device=None) -> torch.Tensor:
    """Blind M2M4 SNR estimate (linear ratio; 10*log10 for dB). For a signal
    of kurtosis ka (PSK: 1, 16-QAM about 1.32) in complex AWGN (kurtosis 2):
    S = sqrt((2 M2^2 - M4) / (2 - ka)), N = M2 - S, SNR = S/N."""
    ka = float(kurtosis_signal)
    if ka >= 2.0:
        raise ValueError("signal kurtosis must be < 2 (the noise kurtosis)")
    st = _moments(state_or_y, device)
    m2 = st.sm2 / st.n
    m4 = st.sm4 / st.n
    s = torch.sqrt(torch.clamp((2.0 * m2 * m2 - m4) / (2.0 - ka), min=0.0))
    noise = torch.clamp(m2 - s, min=1e-12)
    return (s / noise).to(F32)


def blank_impulses(x, guard: int = 2, train: int = 32, pfa: float = 1e-4,
                   device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Impulse-noise blanker: CFAR on |x|^2 marks samples far above the
    local power floor and zeroes them. Returns (cleaned x, blanked mask)."""
    x = as_tensor_on(x, device)
    p = (x.real ** 2 + x.imag ** 2).to(F32)
    det, _ = ca_cfar(p, guard=guard, train=train, pfa=pfa)
    return torch.where(det, torch.zeros((), dtype=x.dtype, device=x.device), x), det
