"""CFAR detection (counterpart of ``srcdsp_tpu/ops/cfar.py``): constant
false-alarm rate thresholding over power series and spectra.

The sliding training-window sums of cell-averaging CFAR come from one
float32 cumulative sum (an integral) and four shifted slices, vectorized
over leading axes. Edge cells see a reflected copy of the series, so every
cell has a full training window and alpha stays exact everywhere.

Calibration: for square-law-detected Gaussian noise (exponential power, the
|FFT|^2 case), CA-CFAR with T training cells has threshold factor
alpha = T * (pfa^(-1/T) - 1), the design false-alarm probability whatever
the noise level. GO-CFAR (greatest of the two half-windows) is for clutter
edges.

`torch.cumsum` sums in another order than XLA's (and differently on the card
than on the CPU), so a threshold matches the reference to float32 rounding
and a cell within that rounding of its threshold may decide either way.
"""

from __future__ import annotations

import numpy as np
import torch

from srcdsp_tpu_torch.device import as_tensor_on
from srcdsp_tpu_torch.types import F32

__all__ = ["cfar_alpha", "ca_cfar", "go_cfar_split"]


def cfar_alpha(num_train: int, pfa: float) -> float:
    """CA-CFAR threshold multiplier for exponential (square-law) noise."""
    return float(num_train * (pfa ** (-1.0 / num_train) - 1.0))


def _window_means(power: torch.Tensor, guard: int, train: int):
    """(lead_mean, lag_mean): means of the `train` cells on each side of
    every cell, skipping `guard` cells, via reflection pad + cumsum."""
    w = guard + train
    if power.shape[-1] < w + 1:
        raise ValueError(f"need at least guard+train+1 = {w + 1} cells, "
                         f"got {power.shape[-1]}")
    p = torch.cat([power[..., 1:w + 1].flip(-1), power,
                   power[..., -w - 1:-1].flip(-1)], dim=-1)
    c = torch.cumsum(p.to(F32), dim=-1)
    c = torch.cat([torch.zeros((*c.shape[:-1], 1), dtype=F32, device=c.device), c], dim=-1)
    n = power.shape[-1]
    # cell i sits at pad position i+w; sums over [i-g-t, i-g) and
    # (i+g, i+g+t] are four static slices of the exclusive cumsum
    lead = c[..., w - guard:w - guard + n] - c[..., 0:n]
    lag = (c[..., 2 * w + 1:2 * w + 1 + n]
           - c[..., w + guard + 1:w + guard + 1 + n])
    return lead / np.float32(train), lag / np.float32(train)


def ca_cfar(power, guard: int = 2, train: int = 16, pfa: float = 1e-3, device=None):
    """Cell-averaging CFAR. power: [..., N] non-negative (square-law); a
    tensor stays on its device, anything else goes to `device` (None = the
    card).

    Returns (detections bool [..., N], threshold f32 [..., N]). The noise
    estimate per cell is the mean of `train` cells on both sides (2*train
    in all) outside `guard` guard cells; threshold = alpha * estimate with
    alpha calibrated for `pfa` under exponential noise.
    """
    power = as_tensor_on(power, device)
    lead, lag = _window_means(power, guard, train)
    noise = 0.5 * (lead + lag)
    thr = np.float32(cfar_alpha(2 * train, pfa)) * noise
    return power > thr, thr


def go_cfar_split(power, guard: int = 2, train: int = 16, pfa: float = 1e-3, device=None):
    """Greatest-of CFAR: noise = max(lead half, lag half). Robust at clutter
    edges (a power step raises the threshold instead of leaking false
    alarms); alpha is the per-half CA alpha, slightly conservative (the
    actual pfa is below the design one), as in the reference."""
    power = as_tensor_on(power, device)
    lead, lag = _window_means(power, guard, train)
    noise = torch.maximum(lead, lag)
    thr = np.float32(cfar_alpha(train, pfa)) * noise
    return power > thr, thr
