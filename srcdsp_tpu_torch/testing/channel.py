"""Channel models: reproducible impairment injection (counterpart of
``srcdsp_tpu/testing/channel.py``).

Randomness comes from an explicit ``np.random.Generator``, as in
`testing.signals`: the same seed gives the same draw on any host. The
generators return numpy complex64 (float64 inside); `multipath_apply` and
`add_noise_snr` take a tensor and keep it on its device (a numpy array comes
back as numpy).

Contents: static multipath, exponential-PDP Rayleigh taps, time-varying
flat Rayleigh fading with the Jakes Doppler spectrum (Pop-Beaulieu
sum of sinusoids), Wiener phase noise and SNR-calibrated AWGN.
"""

from __future__ import annotations

import numpy as np
import torch

from srcdsp_tpu_torch.testing.signals import complex_awgn
from srcdsp_tpu_torch.types import CF32

__all__ = ["multipath_apply", "rayleigh_taps", "jakes_fading", "phase_noise", "add_noise_snr"]


def multipath_apply(h, x):
    """Static FIR channel: y[n] = sum_k h[k] x[n-k], same length as x (causal,
    zero initial state), through `ops.fir.fir_full`'s complex-tap conv."""
    from srcdsp_tpu_torch.ops.fir import fir_full

    if isinstance(x, torch.Tensor):
        return fir_full(torch.as_tensor(np.asarray(h, np.complex64), device=x.device), x.to(CF32))
    return multipath_apply(h, torch.from_numpy(np.ascontiguousarray(x, np.complex64))).numpy()


def rayleigh_taps(rng: np.random.Generator, num_taps: int, decay: float = 1.0) -> np.ndarray:
    """One static Rayleigh multipath realization, E|h[k]|^2 ~ exp(-k/decay),
    unit total power; tap 0 is not line-of-sight."""
    pdp = np.exp(-np.arange(num_taps) / decay)
    pdp = pdp / pdp.sum()
    return (complex_awgn(rng, (num_taps,), power=1.0) * np.sqrt(pdp)).astype(np.complex64)


def jakes_fading(rng: np.random.Generator, n: int, doppler: float, num_sin: int = 16) -> np.ndarray:
    """Time-varying flat Rayleigh fading g[n], unit average power, Jakes
    Doppler spectrum (max Doppler `doppler` cycles/sample): M sinusoids at
    fd cos(alpha_m) with random phases per quadrature."""
    m = num_sin
    alpha = (2 * np.pi * (np.arange(m) + 0.5) / (4 * m)
             + rng.uniform(0.0, 2 * np.pi / (4 * m), m))
    fm = doppler * np.cos(alpha)
    t = np.arange(n, dtype=np.float64)
    phi_i = rng.uniform(0.0, 2 * np.pi, (m, 1))
    phi_q = rng.uniform(0.0, 2 * np.pi, (m, 1))
    arg = 2 * np.pi * fm[:, None] * t[None, :]
    gi = np.cos(arg + phi_i).sum(axis=0)
    gq = np.cos(arg + phi_q).sum(axis=0)
    return (np.sqrt(1.0 / m) * (gi + 1j * gq)).astype(np.complex64)


def phase_noise(rng: np.random.Generator, n: int, linewidth: float) -> np.ndarray:
    """Wiener phase-noise multiplier e^{j theta}, Var[theta[n]] =
    2 pi linewidth n (linewidth in cycles/sample)."""
    theta = np.cumsum(np.sqrt(2.0 * np.pi * linewidth) * rng.standard_normal(n))
    return np.exp(1j * theta).astype(np.complex64)


def add_noise_snr(rng: np.random.Generator, x, snr_db: float):
    """AWGN at `snr_db` below the MEASURED power of x (a tensor stays on its
    device; the noise is drawn on the host and copied there)."""
    noise = complex_awgn(rng, tuple(x.shape), power=1.0)
    if isinstance(x, torch.Tensor):
        p = x.abs().pow(2).mean()
        scale = torch.sqrt(p * 10.0 ** (-snr_db / 10.0))
        return (x + torch.as_tensor(noise, device=x.device) * scale).to(CF32)
    p = np.mean(np.abs(x) ** 2)
    return (x + noise * np.sqrt(p * 10.0 ** (-snr_db / 10.0))).astype(np.complex64)
