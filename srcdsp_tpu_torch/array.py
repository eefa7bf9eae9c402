"""Array processing: beamforming and direction finding (counterpart of
``srcdsp_tpu/array.py``).

Conventions: a uniform linear array of E elements at `spacing` wavelengths;
the steering vector for direction theta (radians from broadside) is
a_e(theta) = exp(-j*2*pi*spacing*e*sin(theta)). Snapshots are [E, N]
(element-major, time minor).

The sample covariance is one [E, N] @ [N, E] complex matmul (TF32 off,
`ops.fir.pin_f32`), streamed block by block through `CovState`; the
Bartlett, MVDR and MUSIC spectra over a steering grid are small dense linear
algebra batched over angles: `torch.linalg.solve` and `torch.linalg.eigh` on
complex64 on the covariance's device, where the reference calls
`jnp.linalg`. MUSIC depends on the eigenvectors only through the noise
subspace's projector, which is what its spectrum reads (eigenvector phases
are arbitrary).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from srcdsp_tpu_torch.device import as_tensor_on, resolve
from srcdsp_tpu_torch.ops.fir import pin_f32
from srcdsp_tpu_torch.types import CF32, F32

__all__ = [
    "ula_steering", "sample_covariance", "CovState", "cov_init",
    "cov_update", "cov_finalize", "bartlett_spectrum", "mvdr_weights",
    "mvdr_spectrum", "music_spectrum", "beamform",
]


def ula_steering(num_elements: int, spacing: float, angles, device=None) -> torch.Tensor:
    """[A, E] steering matrix for a ULA. angles: radians from broadside (a
    tensor stays on its device, anything else goes to `device`, None = the
    card); spacing in wavelengths (0.5 = the standard half-wavelength
    array)."""
    angles = torch.atleast_1d(as_tensor_on(angles, device, F32))
    e = torch.arange(num_elements, dtype=F32, device=angles.device)
    ph = spacing * torch.sin(angles)[:, None] * e[None, :]
    return torch.exp(-1j * (2.0 * np.pi) * ph).to(CF32)


def _gram(x: torch.Tensor) -> torch.Tensor:
    """X X^H over the last (time) axis, TF32 off."""
    pin_f32(x)
    return x @ torch.conj(x).transpose(-2, -1)


def _load(r: torch.Tensor, loading: float) -> torch.Tensor:
    e = r.shape[-1]
    tr = torch.diagonal(r, dim1=-2, dim2=-1).sum(-1).real[..., None, None]
    return r + (loading * tr / e) * torch.eye(e, dtype=r.dtype, device=r.device)


def sample_covariance(x, loading: float = 0.0, device=None) -> torch.Tensor:
    """R = X X^H / N (+ diagonal loading as a fraction of the mean element
    power). x: [..., E, N] -> [..., E, E] complex64."""
    x = as_tensor_on(x, device, CF32)
    r = _gram(x) / x.shape[-1]
    if loading:
        r = _load(r, loading)
    return r.to(CF32)


class CovState(NamedTuple):
    """Streaming covariance accumulator: unnormalized X X^H and count."""

    acc: torch.Tensor     # [..., E, E] complex64
    count: torch.Tensor   # [] or [...] f32 snapshots seen


def cov_init(num_elements: int, channel_shape: tuple = (), device=None) -> CovState:
    dev = resolve(device)
    return CovState(
        acc=torch.zeros((*channel_shape, num_elements, num_elements), dtype=CF32, device=dev),
        count=torch.zeros(channel_shape, dtype=F32, device=dev))


def cov_update(state: CovState, x) -> CovState:
    """Accumulate one [..., E, N] block of snapshots (a non-tensor block goes
    to the state's device)."""
    x = as_tensor_on(x, state.acc.device, CF32)
    return CovState(acc=(state.acc + _gram(x)).to(CF32),
                    count=state.count + np.float32(x.shape[-1]))


def cov_finalize(state: CovState, loading: float = 0.0) -> torch.Tensor:
    r = state.acc / torch.clamp(state.count, min=1.0)[..., None, None]
    if loading:
        r = _load(r, loading)
    return r.to(CF32)


def bartlett_spectrum(r: torch.Tensor, steering: torch.Tensor) -> torch.Tensor:
    """Conventional beamformer power a^H R a / E^2 per steering row."""
    e = steering.shape[-1]
    pin_f32(r)
    ra = torch.einsum("...ef,af->...ae", r, steering)
    p = torch.einsum("...ae,ae->...a", ra, torch.conj(steering)).real
    return (p / (e * e)).to(F32)


def mvdr_weights(r: torch.Tensor, a) -> torch.Tensor:
    """Minimum-variance distortionless weights w = R^-1 a / (a^H R^-1 a).
    a: [E] steering vector of the look direction."""
    a = torch.as_tensor(a, dtype=CF32, device=r.device)
    ri_a = torch.linalg.solve(r, a)
    denom = (torch.conj(a) * ri_a).sum()
    return (ri_a / denom).to(CF32)


def mvdr_spectrum(r: torch.Tensor, steering: torch.Tensor) -> torch.Tensor:
    """Capon spectrum 1 / (a^H R^-1 a) per steering row."""
    ri_s = torch.linalg.solve(r, steering.transpose(-2, -1).to(CF32))   # [E, A]
    q = torch.einsum("ae,...ea->...a", torch.conj(steering), ri_s).real
    return (1.0 / torch.clamp(q, min=1e-30)).to(F32)


def noise_subspace(r: torch.Tensor, num_sources: int) -> torch.Tensor:
    """The eigenvectors of the E - num_sources smallest eigenvalues of R
    (eigh orders them ascending): [..., E, E - S]."""
    _, v = torch.linalg.eigh(r)
    return v[..., :, : v.shape[-1] - num_sources]


def music_spectrum(r: torch.Tensor, steering: torch.Tensor, num_sources: int) -> torch.Tensor:
    """MUSIC pseudospectrum 1 / ||En^H a||^2 over the noise subspace."""
    en = noise_subspace(r, num_sources)
    pin_f32(r)
    proj = torch.einsum("...es,ae->...as", en, torch.conj(steering))
    q = (proj.real ** 2 + proj.imag ** 2).sum(dim=-1)
    return (1.0 / torch.clamp(q, min=1e-30)).to(F32)


def beamform(w: torch.Tensor, x) -> torch.Tensor:
    """y[n] = w^H x[:, n]. w: [E], x: [..., E, N] -> [..., N] (a non-tensor x
    goes to w's device)."""
    x = as_tensor_on(x, w.device, CF32)
    pin_f32(x)
    return torch.einsum("e,...en->...n", torch.conj(w), x).to(CF32)
