"""Spectral estimation: Welch PSD, spectrogram, streaming accumulator
(counterpart of ``srcdsp_tpu/ops/spectrum.py``).

- Framing is one strided view (``unfold``) of the signal: frame f is samples
  [f*hop, f*hop + nfft), F = (S - nfft)//hop + 1. The JAX module builds the
  same frames from shifted slices (or a gather), a TPU layout choice.
- The FFT is pluggable: ``torch.fft.fft`` by default, or pass the port's
  ``ops.fft_planes.make_fft_planes(nfft)`` output via `fft_fn` (it takes and
  returns (re, im) planes [B, nfft]).
- Welch averaging is a mean over frames; the streaming form carries
  (psd_sum, n_frames, tail) so unbounded captures stream block by block with
  bounded memory, and `welch_stream_*` matches the one-shot result when
  block % hop == 0.

Scaling follows scipy.signal.welch conventions (fs=1): 'density' divides by
sum(w^2), 'spectrum' by sum(w)^2.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.ops.fir import pin_f32
from srcdsp_tpu_torch.types import CF32, F32

__all__ = [
    "frame_signal", "welch", "spectrogram",
    "WelchState", "welch_stream_init", "welch_stream_update",
    "welch_stream_finalize",
]


def frame_signal(x: torch.Tensor, nfft: int, hop: int) -> torch.Tensor:
    """[..., S] -> [..., F, nfft] overlapping frames, F = (S-nfft)//hop + 1."""
    s = x.shape[-1]
    if s < nfft:
        raise ValueError(f"signal length {s} < nfft {nfft}")
    return x.unfold(-1, nfft, hop)


def _hann_periodic(n: int) -> np.ndarray:
    # scipy.signal.get_window('hann', n): the periodic form
    return 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)


def _win_np(window, nfft: int) -> np.ndarray:
    if isinstance(window, str):
        if window == "hann":
            w = _hann_periodic(nfft)
        elif window == "hamming":
            w = np.hamming(nfft)
        elif window == "boxcar":
            w = np.ones(nfft)
        else:
            raise ValueError(f"unknown window {window!r}")
        return w.astype(np.float32)
    w = np.asarray(window, np.float32)
    if w.shape != (nfft,):
        raise ValueError(f"window shape {w.shape} != ({nfft},)")
    return w


def _frame_ffts(x: torch.Tensor, nfft: int, hop: int, window, detrend: str | None,
                fft_fn) -> tuple[torch.Tensor, int]:
    pin_f32(x)
    w = torch.as_tensor(_win_np(window, nfft), device=x.device)
    fr = frame_signal(x, nfft, hop)
    if detrend == "constant":
        fr = fr - torch.mean(fr, dim=-1, keepdim=True)
    fr = fr * w
    if fft_fn is None:
        spec = torch.fft.fft(fr, dim=-1)
        p = (spec.real ** 2 + spec.imag ** 2).to(F32)
    else:
        im = fr.imag if fr.is_complex() else torch.zeros_like(fr)
        re, im = fft_fn(fr.real.to(F32).reshape(-1, nfft), im.to(F32).reshape(-1, nfft))
        p = (re ** 2 + im ** 2).to(F32).reshape(fr.shape)
    return p, fr.shape[-2]


def _scale(window, nfft: int, scaling: str) -> float:
    w = _win_np(window, nfft)
    if scaling == "density":
        return float(1.0 / np.sum(w ** 2))
    if scaling == "spectrum":
        return float(1.0 / np.sum(w) ** 2)
    raise ValueError(f"unknown scaling {scaling!r}")


def welch(x: torch.Tensor, nfft: int, hop: int | None = None, window="hann",
          detrend: str | None = "constant", scaling: str = "density",
          fft_fn: Callable | None = None) -> torch.Tensor:
    """Welch PSD over the last axis -> [..., nfft] (two-sided, not
    fftshifted; bin k = frequency k/nfft cycles/sample), as
    scipy.signal.welch(..., return_onesided=False) on its grid."""
    hop = hop if hop is not None else nfft // 2
    p, _ = _frame_ffts(x, nfft, hop, window, detrend, fft_fn)
    return torch.mean(p, dim=-2) * np.float32(_scale(window, nfft, scaling))


def spectrogram(x: torch.Tensor, nfft: int, hop: int | None = None, window="hann",
                detrend: str | None = None, scaling: str = "density",
                fft_fn: Callable | None = None) -> torch.Tensor:
    """Power spectrogram -> [..., F, nfft] (frames-major, two-sided)."""
    hop = hop if hop is not None else nfft // 2
    p, _ = _frame_ffts(x, nfft, hop, window, detrend, fft_fn)
    return p * np.float32(_scale(window, nfft, scaling))


# ---------- streaming Welch ----------

class WelchState(NamedTuple):
    psd_sum: torch.Tensor    # [..., nfft] running sum of frame powers
    count: torch.Tensor      # [] or [...] frame count (f32; exact for < 2^24)
    tail: torch.Tensor       # [..., nfft - hop] carried overlap samples


def welch_stream_init(nfft: int, hop: int | None = None, channel_shape: tuple = (),
                      dtype=CF32, device=None) -> WelchState:
    hop = hop if hop is not None else nfft // 2
    device = resolve(device)
    return WelchState(psd_sum=torch.zeros((*channel_shape, nfft), dtype=F32, device=device),
                      count=torch.zeros(channel_shape, dtype=F32, device=device),
                      tail=torch.zeros((*channel_shape, nfft - hop), dtype=dtype,
                                       device=device))


def welch_stream_update(state: WelchState, x: torch.Tensor, nfft: int, hop: int | None = None,
                        window="hann", detrend: str | None = "constant",
                        fft_fn: Callable | None = None, first: bool = False) -> WelchState:
    """Accumulate one block. Requires block length % hop == 0 and hop | nfft;
    the carried (nfft - hop)-sample tail makes the framing seam-free, so the
    finalized PSD equals the one-shot `welch` on the concatenated capture;
    pass first=True on the initial block (it drops the frames that would
    overlap the zero-filled initial tail, which the one-shot never sees)."""
    hop = hop if hop is not None else nfft // 2
    n = x.shape[-1]
    if n % hop != 0:
        raise ValueError(f"block length {n} not divisible by hop {hop}")
    if nfft % hop != 0:
        raise ValueError(f"streaming form requires hop | nfft (got nfft={nfft}, hop={hop})")
    xin = torch.cat([state.tail, x], dim=-1)
    p, nf = _frame_ffts(xin, nfft, hop, window, detrend, fft_fn)
    if first:
        skip = (nfft - hop) // hop   # frames touching the zero prefix
        p = p[..., skip:, :]
        nf -= skip
    tail_len = nfft - hop
    new_tail = xin[..., xin.shape[-1] - tail_len:] if tail_len > 0 else state.tail
    return WelchState(psd_sum=state.psd_sum + torch.sum(p, dim=-2),
                      count=state.count + np.float32(nf), tail=new_tail)


def welch_stream_finalize(state: WelchState, nfft: int, window="hann",
                          scaling: str = "density") -> torch.Tensor:
    return state.psd_sum / state.count[..., None] * np.float32(_scale(window, nfft, scaling))
