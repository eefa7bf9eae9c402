"""Overlap-save FFT convolution (counterpart of ``srcdsp_tpu/ops/fftconv.py``).

The reference's ``jnp.fft`` tier: ``torch.fft`` on complex64 over a batch of
overlapped frames, with the frequency response made once. Semantics are the
causal FIR from rest of ``ops.fir`` (y[n] = sum h[k] x[n-k]), so the two are
interchangeable.

Streaming: the carried tail is the last (fft_size - hop) input samples; each
frame is [tail | new samples] cut at stride hop (an ``unfold`` view), and the
first (fft_size - hop) samples of every inverse transform are circular
wrap and are dropped. hop defaults to fft_size - (num_taps - 1), the largest
valid hop (3073 at 1024 taps and fft 4096).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.types import CF32


class FftConvState(NamedTuple):
    """Carried overlap: last (fft_size - hop) input samples."""

    tail: torch.Tensor  # [..., fft_size - hop] complex64


def default_hop(num_taps: int, fft_size: int) -> int:
    return fft_size - (num_taps - 1)


def make_freq_response(taps, fft_size: int, device=None) -> torch.Tensor:
    """H = FFT(taps zero-padded to fft_size), complex64 (as the reference:
    the taps cast to complex64, then one complex64 FFT)."""
    h = torch.as_tensor(taps).to(CF32).to(resolve(device))
    if h.shape[0] > fft_size:
        raise ValueError(f"num_taps {h.shape[0]} > fft_size {fft_size}")
    return torch.fft.fft(h, n=fft_size)


def _check_hop(num_taps: int, fft_size: int, hop: int) -> None:
    if not 0 < hop <= fft_size - (num_taps - 1):
        raise ValueError(
            f"hop must be in (0, fft_size - num_taps + 1] = (0, "
            f"{fft_size - num_taps + 1}], got {hop}")


def fftconv_init(num_taps: int, fft_size: int, channel_shape: tuple = (),
                 hop: int | None = None, dtype=CF32, device=None) -> FftConvState:
    hop = default_hop(num_taps, fft_size) if hop is None else hop
    _check_hop(num_taps, fft_size, hop)
    return FftConvState(tail=torch.zeros((*channel_shape, fft_size - hop), dtype=dtype,
                                         device=resolve(device)))


def fftconv_apply(freq_response: torch.Tensor, num_taps: int, state: FftConvState,
                  x: torch.Tensor, hop: int | None = None
                  ) -> tuple[FftConvState, torch.Tensor]:
    """Filter one block via overlap-save. x: [..., N], N % hop == 0 -> [..., N]."""
    f = freq_response.shape[-1]
    hop = default_hop(num_taps, f) if hop is None else hop
    _check_hop(num_taps, f, hop)
    overlap = f - hop
    n = x.shape[-1]
    if n % hop != 0:
        raise ValueError(f"block length {n} not divisible by hop {hop}")
    xin = torch.cat([state.tail, x], dim=-1)            # [..., overlap + N]
    frames = xin.unfold(-1, f, hop)                     # [..., N/hop, F]: frame j at j*hop
    spec = torch.fft.fft(frames, dim=-1) * freq_response
    y = torch.fft.ifft(spec, dim=-1)[..., overlap:]     # drop the circular wrap
    y = y.reshape(*x.shape[:-1], n).to(CF32)
    return FftConvState(tail=xin[..., xin.shape[-1] - overlap:]), y


def fftconv_full(taps, x: torch.Tensor, fft_size: int, hop: int | None = None
                 ) -> torch.Tensor:
    """Whole-signal overlap-save filter from rest (one-shot convenience)."""
    taps = torch.as_tensor(taps)
    h = make_freq_response(taps, fft_size, device=x.device)
    state = fftconv_init(taps.shape[0], fft_size, channel_shape=tuple(x.shape[:-1]),
                         hop=hop, device=x.device)
    _, y = fftconv_apply(h, taps.shape[0], state, x, hop=hop)
    return y
