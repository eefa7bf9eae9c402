"""Acceleration search: detection of linearly drifting tones that a plain
FFT smears away (counterpart of ``srcdsp_tpu/ops/accel.py``).

A tone drifting at r cycles/sample^2 spreads over r*N^2 bins of an N-point
DFT. The matched statistic Z(r, f) = sum_n x[n] exp(-j pi r n^2)
exp(-j 2 pi f n) is, for each drift hypothesis, one quadratic dechirp and one
FFT row: the search is an [R, N] elementwise product and a batched FFT on the
capture's device. The dechirp phase r*n^2/2 mod 1 is formed on the device in
float64 with the reference's operations in its order, so it equals numpy's;
its complex exponential is taken in float64 and rounded to complex64. The
metric comes back to the host once; the peak and its parabolic refinement
are host code, as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from srcdsp_tpu_torch.device import as_tensor_on
from srcdsp_tpu_torch.types import CF32

__all__ = ["AccelResult", "accel_grid", "accel_search"]


class AccelResult(NamedTuple):
    metric: np.ndarray      # [R, N] |Z|
    rates: np.ndarray       # [R] drift grid, cycles/sample^2
    freq: float             # refined peak frequency, cycles/sample
    drift: float            # refined drift rate, cycles/sample^2
    snr_db: float           # peak over the metric's median floor
    ratio: float            # peak / median (detection statistic)


def accel_grid(n: int, max_drift: float) -> np.ndarray:
    """Drift grid covering +-max_drift at the ~2/N^2 matched pitch."""
    step = 2.0 / (n * n)
    k = int(np.ceil(max_drift / step))
    return np.arange(-k, k + 1) * step


def dechirp_phasors(rates: np.ndarray, n: int, device) -> torch.Tensor:
    """[R, N] complex64 exp(-j 2 pi frac(r n^2 / 2)), the fraction in float64
    on `device` (equal to numpy's `np.mod(rates[:, None] * (idx * idx)[None,
    :] / 2.0, 1.0)`)."""
    f64 = torch.float64
    r = torch.as_tensor(np.asarray(rates, np.float64), device=device)
    idx = torch.arange(n, dtype=f64, device=device)
    fr = torch.remainder(r[:, None] * (idx * idx)[None, :] / 2.0, 1.0)
    ph = (-2.0 * np.pi) * fr
    return torch.complex(torch.cos(ph), torch.sin(ph)).to(CF32)


def accel_search(x, rates: np.ndarray | None = None,
                 max_drift: float | None = None, device=None) -> AccelResult:
    """Search a block [N] for a drifting tone (a tensor stays on its device;
    anything else goes to `device`, None = the card).

    rates: explicit drift grid, or computed from max_drift via accel_grid.
    Returns the full [R, N] metric (numpy) plus the refined (freq, drift)
    peak; freq is the tone's frequency at block start (n = 0), the frequency
    at sample n being freq + drift*n."""
    xx = as_tensor_on(x, device).to(CF32)
    n = int(xx.shape[-1])
    if rates is None:
        if max_drift is None:
            raise ValueError("give rates or max_drift")
        rates = accel_grid(n, max_drift)
    rates = np.asarray(rates, np.float64)
    z = torch.fft.fft(dechirp_phasors(rates, n, xx.device) * xx[None, :], dim=-1)
    mag = torch.abs(z).cpu().numpy()
    ri, fi = np.unravel_index(np.argmax(mag), mag.shape)

    def _para(y0, y1, y2):
        d = y0 - 2 * y1 + y2
        return 0.5 * (y0 - y2) / d if abs(d) > 1e-12 else 0.0

    # both neighbours wrap circularly, so the refinement holds at every bin
    foff = _para(mag[ri, fi - 1], mag[ri, fi], mag[ri, (fi + 1) % n])
    roff = _para(mag[ri - 1, fi], mag[ri, fi],
                 mag[ri + 1, fi]) if 0 < ri < mag.shape[0] - 1 else 0.0
    rstep = rates[1] - rates[0] if rates.size > 1 else 0.0
    freq = (fi + foff) / n
    if freq > 0.5:
        freq -= 1.0
    med = float(np.median(mag))
    pk = float(mag[ri, fi])
    return AccelResult(
        metric=mag, rates=rates, freq=float(freq),
        drift=float(rates[ri] + roff * rstep),
        snr_db=float(20 * np.log10(pk / max(med, 1e-30))),
        ratio=pk / max(med, 1e-30))
