"""Pulse-Doppler radar processing (counterpart of ``srcdsp_tpu/ops/radar.py``):
the LFM chirp fixture (``testing.signals.chirp``), matched filtering and the
CFAR machinery composed into the radar data cube pipeline.

    pulses [P, N] -> pulse_compress (batched matched filter)
                  -> range_doppler (windowed DFT across pulses)
                  -> |.|^2 -> cfar_2d (integral-image CA-CFAR)
                  -> detections

Each stage is one batched tensor op on the cube's device: the matched filter
one FFT-domain multiply over all pulses, the Doppler transform one FFT over
the pulse axis, the 2-D CFAR training-ring means four corner reads of an
integral image (two float32 cumsums) of the reflect-padded map. The
detection list is a host sink. `torch.cumsum` sums in another order than
XLA's, so thresholds match the reference to float32 rounding, as for
``ops.cfar``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from srcdsp_tpu_torch.device import as_tensor_on
from srcdsp_tpu_torch.types import F32

__all__ = ["pulse_compress", "range_doppler", "cfar_alpha_2d", "cfar_2d",
           "detections"]


def pulse_compress(pulses, ref, device=None) -> torch.Tensor:
    """[P, N] complex fast-time pulses x [L] reference waveform -> [P, N]
    matched-filter output, peak at the target's delay bin (circular). A
    tensor stays on its device; anything else goes to `device` (None = the
    card), the reference waveform to the pulses' device."""
    pulses = as_tensor_on(pulses, device)
    n = pulses.shape[-1]
    h = torch.conj(torch.as_tensor(ref, device=pulses.device)).flip(-1)
    hf = torch.fft.fft(torch.cat([h, torch.zeros(n - h.shape[0], dtype=h.dtype,
                                                 device=h.device)]))
    y = torch.fft.ifft(torch.fft.fft(pulses, dim=-1) * hf[None, :], dim=-1)
    # remove the L-1 filter delay, circularly, so the peak lands at the delay
    return torch.roll(y, -(h.shape[0] - 1), dims=-1)


def range_doppler(pulses, ref, window: str = "hann", device=None) -> torch.Tensor:
    """[P, N] pulses -> [P, N] complex range-Doppler map: matched filter in
    fast time, windowed DFT in slow time, fftshifted so Doppler bin P//2 is
    zero velocity. The Hann window is numpy's, in float32."""
    mf = pulse_compress(pulses, ref, device)
    p = mf.shape[0]
    if window == "hann":
        w = torch.as_tensor(np.hanning(p).astype(np.float32), device=mf.device)
    elif window is None or window == "rect":
        w = torch.ones(p, dtype=F32, device=mf.device)
    else:
        raise ValueError(f"unknown window {window!r}")
    return torch.fft.fftshift(torch.fft.fft(mf * w[:, None].to(mf.dtype), dim=0), dim=0)


def cfar_alpha_2d(num_train: int, pfa: float) -> float:
    """CA-CFAR threshold multiplier for a 2-D ring of `num_train` training
    cells (the exponential-noise closed form of ``ops.cfar.cfar_alpha``)."""
    return float(num_train * (pfa ** (-1.0 / num_train) - 1.0))


def _integral(power: torch.Tensor) -> torch.Tensor:
    """[D, R] -> [(D+1), (R+1)] integral image (zero row/col 0)."""
    s = torch.cumsum(torch.cumsum(power, dim=0), dim=1)
    return F.pad(s, (1, 0, 1, 0))


def _box_sum(ii: torch.Tensor, half: int, d: int, r: int) -> torch.Tensor:
    """Sum of the (2*half+1)^2 box around every cell, from the integral image
    of the map padded by `half` on each side: four static slices."""
    k = 2 * half + 1
    return (ii[k:, k:] - ii[:-k, k:] - ii[k:, :-k] + ii[:-k, :-k])[:d, :r]


def cfar_2d(power, guard: int = 1, train: int = 4, pfa: float = 1e-4,
            device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """2-D CA-CFAR over a [D, R] power map. Returns (mask bool [D, R],
    threshold [D, R]).

    Training region = the square ring between the guard box (2*guard+1)^2
    and the outer box (2*(guard+train)+1)^2, means from one integral image
    of the reflect-padded map (``jnp.pad(mode="reflect")``: the edge cell is
    not repeated; each pad must be shorter than its axis); alpha from the
    exponential-noise closed form."""
    power = as_tensor_on(power, device)
    d, r = power.shape
    ho = guard + train
    pad = F.pad(power[None], (ho, ho, ho, ho), mode="reflect")[0]
    ii = _integral(pad)
    outer = _box_sum(ii, ho, d, r)
    off = ho - guard
    kg = 2 * guard + 1
    inner = (ii[off + kg: off + kg + d, off + kg: off + kg + r]
             - ii[off: off + d, off + kg: off + kg + r]
             - ii[off + kg: off + kg + d, off: off + r]
             + ii[off: off + d, off: off + r])
    n_train = (2 * ho + 1) ** 2 - kg ** 2
    noise = (outer - inner) / np.float32(n_train)
    thr = np.float32(cfar_alpha_2d(n_train, pfa)) * noise
    return power > thr, thr


def detections(power, mask) -> np.ndarray:
    """Host sink: (doppler_bin, range_bin, power) rows for local maxima among
    CFAR hits (8-neighbour max suppression), strongest first, as numpy
    object rows."""
    p = power.cpu().numpy() if isinstance(power, torch.Tensor) else np.asarray(power)
    m = mask.cpu().numpy() if isinstance(mask, torch.Tensor) else np.asarray(mask)
    pp = np.pad(p, 1, mode="constant", constant_values=-np.inf)
    local = np.ones_like(m)
    for dd in (-1, 0, 1):
        for dr in (-1, 0, 1):
            if dd == 0 and dr == 0:
                continue
            local &= p >= pp[1 + dd: 1 + dd + p.shape[0], 1 + dr: 1 + dr + p.shape[1]]
    hits = np.argwhere(m & local)
    rows = sorted(((int(a), int(b), float(p[a, b])) for a, b in hits), key=lambda t: -t[2])
    return np.asarray(rows, dtype=object)
