"""Soft-decision demappers: bit LLRs from noisy symbols (counterpart of
``srcdsp_tpu/demap.py``).

Positive LLR favours bit 0 (the convention of `ldpc` and `turbo`):

    llr[n, b] = (min_{s: bit_b(s)=1} |y_n - c_s|^2
                 - min_{s: bit_b(s)=0} |y_n - c_s|^2) / sigma2

`maxlog_llr` works for any labelled constellation through one [..., N, M]
distance array and two masked min-reductions per bit. `qam_llr_bitplanes` is
the modem's form: the Gray labelling splits into an I half and a Q half, so
each bit's LLR is a 1-D PAM LLR on one axis, elementwise on planes.
Constellations are host numpy complex64.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from srcdsp_tpu_torch.chains.psk import constellation_offset
from srcdsp_tpu_torch.chains.qam import _axis_levels, _inv_gray, qam_constellation, qam_scale
from srcdsp_tpu_torch.ldpc import BIG
from srcdsp_tpu_torch.types import F32


def psk_points(order: int) -> np.ndarray:
    """[order] M-PSK constellation, point m = exp(j*2*pi*(m+off)/M) (the
    convention of chains.psk)."""
    off = constellation_offset(order)
    m = np.arange(order)
    return np.exp(2j * np.pi * (m + off) / order).astype(np.complex64)


def maxlog_llr(y: torch.Tensor, points, sigma2, labels: np.ndarray | None = None
               ) -> torch.Tensor:
    """Max-log LLRs for a labelled constellation: y [..., N] complex,
    points [M], labels [M] (default the point index), sigma2 the noise
    variance per complex symbol. Returns [..., N, log2(M)] float32, bit 0 =
    the label's MSB."""
    pts = torch.as_tensor(np.asarray(points, np.complex64), device=y.device)
    m = pts.shape[-1]
    nbits = int(m).bit_length() - 1
    if (1 << nbits) != m:
        raise ValueError(f"constellation size {m} is not a power of two")
    lab = np.arange(m) if labels is None else np.asarray(labels)
    d2 = torch.abs(y[..., None] - pts) ** 2
    cols = []
    for b in range(nbits):
        ones = torch.as_tensor(((lab >> (nbits - 1 - b)) & 1) == 1, device=y.device)
        d1 = torch.amin(torch.where(ones, d2, float(BIG)), dim=-1)
        d0 = torch.amin(torch.where(ones, float(BIG), d2), dim=-1)
        cols.append(d1 - d0)
    sig = torch.as_tensor(sigma2, dtype=F32, device=y.device)
    return (torch.stack(cols, dim=-1) / sig).to(F32)


def psk_llr(y: torch.Tensor, order: int, sigma2) -> torch.Tensor:
    """LLRs for M-PSK with binary index labels."""
    return maxlog_llr(y, psk_points(order), sigma2)


def qam_llr(y: torch.Tensor, order: int, sigma2) -> torch.Tensor:
    """LLRs for square QAM; the constellation is indexed by its Gray label."""
    return maxlog_llr(y, qam_constellation(order), sigma2)


def qam_llr_bitplanes(yr: torch.Tensor, yi: torch.Tensor, order: int, sigma2=1.0) -> list:
    """Exact max-log square-QAM LLRs as log2(order) planes shaped like yr,
    plane b the LLR of label bit b (MSB first): bits [0, bits_ax) from the I
    level alone, the rest from Q. Equal to `qam_llr` up to the float rounding
    of the cancelled cross-axis term; decisions of normalized min-sum do not
    depend on sigma2."""
    l = _axis_levels(order)
    bits_ax = l.bit_length() - 1
    lev = ((2 * _inv_gray(l) - (l - 1)) * qam_scale(order)).astype(np.float32)
    inv_s2 = float(np.float32(1.0) / np.float32(sigma2))

    def axis_cols(y):
        d2 = [(y - float(lev[g])) ** 2 for g in range(l)]
        cols = []
        for b in range(bits_ax):
            ones = [g for g in range(l) if (g >> (bits_ax - 1 - b)) & 1]
            zeros = [g for g in range(l) if g not in ones]
            d1 = functools.reduce(torch.minimum, [d2[g] for g in ones])
            d0 = functools.reduce(torch.minimum, [d2[g] for g in zeros])
            cols.append(((d1 - d0) * inv_s2).to(F32))
        return cols

    return axis_cols(yr) + axis_cols(yi)


def qam_llr_planes(yr: torch.Tensor, yi: torch.Tensor, order: int, sigma2=1.0
                   ) -> torch.Tensor:
    """`qam_llr_bitplanes` stacked minor-most: [..., N, log2(order)]."""
    return torch.stack(qam_llr_bitplanes(yr, yi, order, sigma2), dim=-1)


def apsk_constellation(order: int, gamma=None) -> np.ndarray:
    """DVB-S2-style APSK, unit average power: 16APSK rings of 4 + 12 points
    (ring ratio gamma, default 2.7); 32APSK 4 + 12 + 16 (default (2.53,
    4.3)). Index = (ring, position) inner first."""
    if order == 16:
        if gamma is not None and np.ndim(gamma) != 0:
            raise ValueError("16APSK takes a single ring-ratio gamma")
        g = 2.7 if gamma is None else float(gamma)
        counts, radii = (4, 12), (1.0, g)
    elif order == 32:
        if gamma is not None and (np.ndim(gamma) != 1 or len(gamma) != 2):
            raise ValueError("32APSK takes gamma=(g1, g2) ring ratios")
        g1, g2 = (2.53, 4.3) if gamma is None else gamma
        counts, radii = (4, 12, 16), (1.0, g1, g2)
    else:
        raise ValueError("apsk_constellation supports order 16 or 32")
    pts = []
    for c, r, off in zip(counts, radii, (np.pi / 4, np.pi / 12, 0.0)):
        ang = 2 * np.pi * np.arange(c) / c + off
        pts.append(r * np.exp(1j * ang))
    pts = np.concatenate(pts)
    pts = pts / np.sqrt(np.mean(np.abs(pts) ** 2))
    return pts.astype(np.complex64)
