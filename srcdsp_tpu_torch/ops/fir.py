"""FIR and decimating FIR filters (counterpart of ``srcdsp_tpu/ops/fir.py``).

The delay line is an explicit carried overlap buffer of the last
``num_taps - 1`` input samples, so block-streamed output equals
whole-signal filtering. The MAC loop is one ``conv1d`` over the block with
the decimation as its stride; complex I/Q runs as real conv channels (a 2x2
channel-mixing kernel for complex taps).

Semantics (the contract the C++ oracle mirrors): causal direct-form FIR from
zero initial state, y[n] = sum_k h[k] x[n-k]; decimation keeps y[j*M].
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.types import CF32, F32


def pin_f32(t: torch.Tensor) -> None:
    """Keep float32 matmuls and convolutions in full float32 on the card.

    cuDNN runs float32 convolutions in TF32 by default (about three decimal
    digits); the plain tier is a float32 reference, so it turns that off.
    """
    if t.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


class FirState(NamedTuple):
    """Carried overlap buffer: the last ``num_taps - 1`` input samples."""

    tail: torch.Tensor  # [..., num_taps - 1] complex64


def fir_init(num_taps: int, channel_shape: tuple = (), dtype=CF32, device=None) -> FirState:
    """Zero state == zero-filled delay line (causal filter from rest)."""
    return FirState(tail=torch.zeros((*channel_shape, num_taps - 1), dtype=dtype,
                                     device=resolve(device)))


def _as_taps(taps, device) -> torch.Tensor:
    t = torch.as_tensor(taps, device=device)
    if t.ndim != 1:
        raise ValueError(f"taps must be 1-D, got shape {tuple(t.shape)}")
    return t


def _dilate_pad(x: torch.Tensor, lhs_dilation: int, padding) -> torch.Tensor:
    """x [..., N] upsampled by `lhs_dilation` (zeros between samples), then
    padded by ``padding = ((lo, hi),)`` in the dilated domain; a negative
    side crops, as XLA's padding does."""
    if lhs_dilation < 1:
        raise ValueError(f"lhs_dilation must be >= 1, got {lhs_dilation}")
    (lo, hi), = padding
    n = x.shape[-1]
    if lhs_dilation > 1 and n > 0:
        u = x.new_zeros((*x.shape[:-1], (n - 1) * lhs_dilation + 1))
        u[..., ::lhs_dilation] = x
        x = u
    return F.pad(x, (int(lo), int(hi))) if (lo, hi) != (0, 0) else x


def complex_conv(xin: torch.Tensor, taps, stride: int = 1, lhs_dilation: int = 1,
                 padding=((0, 0),)) -> torch.Tensor:
    """Strided/dilated true convolution of complex data with (real|complex) taps.

    y[n] = sum_k h[k] u[n*stride + T-1 - k] where u is xin upsampled by
    `lhs_dilation` (zeros between samples) and padded per `padding` (applied
    in the dilated domain; the defaults give valid mode). conv1d is a
    correlation, so the taps go in reversed.
    """
    pin_f32(xin)
    taps = _as_taps(taps, xin.device)
    T = taps.shape[0]
    lead = xin.shape[:-1]
    nin = xin.shape[-1]
    xr = xin.real.to(F32).reshape(-1, 1, nin)
    # a real input is complex with zero imaginary part, as jnp.imag makes it
    xi = xin.imag.to(F32).reshape(-1, 1, nin) if xin.is_complex() else torch.zeros_like(xr)
    xr, xi = _dilate_pad(xr, lhs_dilation, padding), _dilate_pad(xi, lhs_dilation, padding)
    hrev = taps.flip(0)
    if taps.is_complex():
        # channel-mixing conv: (yr, yi) = [[hr, -hi], [hi, hr]] * (xr, xi)
        hr = hrev.real.to(F32)
        hi = hrev.imag.to(F32)
        w = torch.stack([torch.stack([hr, -hi]), torch.stack([hi, hr])])  # [2, 2, T]
        out = F.conv1d(torch.cat([xr, xi], dim=1), w, stride=stride)
        yr, yi = out[:, 0, :], out[:, 1, :]
    else:
        # real taps: I and Q as extra batch rows through one filter
        b = xr.shape[0]
        out = F.conv1d(torch.cat([xr, xi], dim=0), hrev.to(F32).reshape(1, 1, T),
                       stride=stride)
        yr, yi = out[:b, 0, :], out[b:, 0, :]
    y = torch.complex(yr, yi)
    return y.reshape(*lead, y.shape[-1])


def fir_apply(taps, state: FirState, x: torch.Tensor, decim: int = 1
              ) -> tuple[FirState, torch.Tensor]:
    """Filter one block. x: [..., N] with N % decim == 0 -> y: [..., N//decim].

    Concatenating the outputs of successive blocks equals filtering the
    concatenated input (the carried tail is exact).
    """
    taps = _as_taps(taps, x.device)
    T = taps.shape[0]
    n = x.shape[-1]
    if n % decim != 0:
        raise ValueError(f"block length {n} not divisible by decimation {decim}")
    xin = torch.cat([state.tail, x], dim=-1)  # [..., N + T - 1]
    y = complex_conv(xin, taps, stride=decim)
    new_tail = xin[..., n:n + T - 1] if T > 1 else state.tail
    return FirState(tail=new_tail), y


def fir_full(taps, x: torch.Tensor, decim: int = 1) -> torch.Tensor:
    """Whole-signal causal FIR from zero state (one-shot convenience)."""
    taps = _as_taps(taps, x.device)
    state = fir_init(taps.shape[0], channel_shape=tuple(x.shape[:-1]), dtype=x.dtype,
                     device=x.device)
    _, y = fir_apply(taps, state, x, decim=decim)
    return y


def np_fir_full(taps: np.ndarray, x: np.ndarray, decim: int = 1) -> np.ndarray:
    """numpy reference twin of fir_full (float64 accumulate), for tests."""
    T = len(taps)
    xin = np.concatenate([np.zeros(x.shape[:-1] + (T - 1,), dtype=x.dtype), x], axis=-1)
    n = x.shape[-1]
    out = np.stack([
        np.sum(taps[::-1] * xin[..., j * decim: j * decim + T], axis=-1)
        for j in range(n // decim)
    ], axis=-1)
    return out.astype(x.dtype)


def convolve_same(x: torch.Tensor, taps) -> torch.Tensor:
    """numpy's / jnp's ``convolve(x, h, mode="same")`` for real x [..., N]
    (N >= M) and real taps [M]: the full convolution cropped from (M-1)//2,
    one ``conv1d`` with the taps flipped (conv1d correlates), M//2 zeros on
    the left and (M-1)//2 on the right."""
    pin_f32(x)
    h = _as_taps(taps, x.device).to(F32)
    m = h.shape[0]
    lead = x.shape[:-1]
    xp = F.pad(x.to(F32).reshape(-1, 1, x.shape[-1]), (m // 2, (m - 1) // 2))
    y = F.conv1d(xp, h.flip(0).reshape(1, 1, m))
    return y.reshape(*lead, y.shape[-1])
