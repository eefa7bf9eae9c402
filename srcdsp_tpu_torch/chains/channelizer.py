"""Polyphase analysis and synthesis banks (counterpart of
``srcdsp_tpu/chains/channelizer.py``), the complex tier.

Splits one wideband stream into M critically-sampled channels; channel m is
centred at +m/M cycles/sample:

    y_m[k] = sum_j h[j] x[kM-j] e^{+j*2*pi*m*j/M}
           = decimate_M( FIR_h( x[n] * e^{-j*2*pi*m*n/M} ) )[k]     (exact)

evaluated as a fold of the last T input samples of each frame onto M phases,
v[k, p] = sum_l h[lM + p] x[kM - lM - p], then the M-point DFT
Y[k, m] = sum_p v[k, p] e^{+j*2*pi*m*p/M} (the reference's ``ifft * M``).

Both sums run in a fixed order, term by term over the lag l and then over the
phase p, as separate float32 multiplies and adds on real planes. Each frame's
arithmetic is then the same whatever the block length, so block joins are
bit-exact on any device (the reference's contract). ``torch.fft`` was
batch-independent on the CPU in a check, but nothing promises that for every
device and batch, so the port does not lean on it. The twiddles are made in
float64 and rounded to float32 once. Streaming state is the last T-1 input
samples (analysis) or the last phase frames (synthesis).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.ops.window import lowpass
from srcdsp_tpu_torch.types import CF32, F32


class ChannelizerState(NamedTuple):
    """Carried input tail (analysis: the last T-1 wideband samples;
    synthesis: the last phase frames)."""

    tail: torch.Tensor  # [..., L] complex64


def design_prototype(num_channels: int, taps_per_phase: int = 8,
                     cutoff_scale: float = 1.0, atten_db: float = 70.0) -> np.ndarray:
    """Kaiser lowpass prototype, length P*M, cutoff at the channel half-width."""
    t = taps_per_phase * num_channels
    return lowpass(t, cutoff_scale * 0.5 / num_channels, window="kaiser",
                   atten_db=atten_db)


def pad_prototype(taps, num_channels: int) -> np.ndarray:
    """Zero-pad taps to a multiple of M (no-op on the math), as float32."""
    h = np.asarray(taps.cpu() if isinstance(taps, torch.Tensor) else taps, np.float32)
    return np.pad(h, (0, (-h.shape[0]) % num_channels))


def _proto(taps, m: int, device) -> tuple[torch.Tensor, int, int]:
    h = torch.as_tensor(pad_prototype(taps, m), device=device)
    return h, h.shape[0], h.shape[0] // m


def channelizer_init(taps, num_channels: int, channel_shape: tuple = (), dtype=CF32,
                     device=None) -> ChannelizerState:
    t = pad_prototype(taps, num_channels).shape[0]
    return ChannelizerState(tail=torch.zeros((*channel_shape, t - 1), dtype=dtype,
                                             device=resolve(device)))


def dft_twiddles(m: int) -> tuple[np.ndarray, np.ndarray]:
    """W[p, c] = e^{+j*2*pi*c*p/M}, made in float64 and rounded to float32."""
    w = np.exp(2j * np.pi * np.outer(np.arange(m), np.arange(m)) / m)
    return w.real.astype(np.float32), w.imag.astype(np.float32)


def dft_rows(vr: torch.Tensor, vi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Y[..., k, c] = sum_p v[..., k, p] e^{+j*2*pi*c*p/M} over planes
    [..., K, M], summed over p in ascending order (M * ifft over the last axis)."""
    m = vr.shape[-1]
    wr_np, wi_np = dft_twiddles(m)
    wr, wi = torch.as_tensor(wr_np, device=vr.device), torch.as_tensor(wi_np, device=vr.device)
    yr = yi = None
    for p in range(m):
        a, b = vr[..., p:p + 1], vi[..., p:p + 1]
        tr = a * wr[p] - b * wi[p]
        ti = a * wi[p] + b * wr[p]
        yr, yi = (tr, ti) if p == 0 else (yr + tr, yi + ti)
    return yr, yi


def _fold(xr: torch.Tensor, xi: torch.Tensor, h: torch.Tensor, m: int, step: int
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """v[..., k, p] = sum_l h[lM + p] x[k*step + T-1 - lM - p] over planes of
    xin [..., (K-1)*step + T], l ascending."""
    t = h.shape[0]
    wr, wi = xr.unfold(-1, t, step), xi.unfold(-1, t, step)     # [..., K, T]
    hf = h.flip(0)
    ar = ai = None
    for l in range(t // m):
        # window positions T-(l+1)M .. T-lM-1 hold phases p = M-1 .. 0
        sl = slice(t - (l + 1) * m, t - l * m)
        tr, ti = wr[..., sl] * hf[sl], wi[..., sl] * hf[sl]
        ar, ai = (tr, ti) if l == 0 else (ar + tr, ai + ti)
    return ar.flip(-1), ai.flip(-1)


def _analysis(taps, state: ChannelizerState, x: torch.Tensor, m: int, hop: int):
    h, t, _ = _proto(taps, m, x.device)
    n = x.shape[-1]
    if n % hop != 0:
        what = "num_channels" if hop == m else "hop"
        raise ValueError(f"block length {n} not divisible by {what} {hop}")
    xin = torch.cat([state.tail, x.to(CF32)], dim=-1)            # [..., N + T - 1]
    vr, vi = _fold(xin.real, xin.imag, h, m, hop)                # [..., K, M]
    yr, yi = dft_rows(vr, vi)
    new_tail = xin[..., xin.shape[-1] - (t - 1):]
    return ChannelizerState(tail=new_tail), yr, yi


def channelize_apply(taps, state: ChannelizerState, x: torch.Tensor, num_channels: int
                     ) -> tuple[ChannelizerState, torch.Tensor]:
    """Channelize one block. x: [..., N], N % M == 0 -> y: [..., M, N//M].

    y[..., m, k] is channel m (center +m/M cycles/sample) at rate fs/M.
    """
    st, yr, yi = _analysis(taps, state, x, num_channels, num_channels)
    return st, torch.complex(yr, yi).transpose(-1, -2).contiguous()


def channelize_full(taps, x: torch.Tensor, num_channels: int) -> torch.Tensor:
    """Whole-signal channelizer from rest (one-shot convenience)."""
    state = channelizer_init(taps, num_channels, channel_shape=tuple(x.shape[:-1]),
                             device=x.device)
    _, y = channelize_apply(taps, state, x, num_channels)
    return y


def synthesize_apply(taps, state: ChannelizerState, y: torch.Tensor, num_channels: int
                     ) -> tuple[ChannelizerState, torch.Tensor]:
    """Polyphase synthesis bank: combine M channel streams into one wideband.

    y: [..., M, K] channel streams -> x: [..., M*K] wideband at rate fs.

        x[sM+q] = M * sum_l f_q[l] v[s-l, q],   f_q[l] = h[lM+q],
        v[k, q] = sum_m y[m, k] e^{+j*2*pi*m*q/M}

    (each channel upsampled by M, interpolated by the prototype and mixed to
    +m/M). State carries the last P-1 phase frames as [..., (P-1)*M].
    """
    m = num_channels
    h, _, p = _proto(taps, m, y.device)
    kk = y.shape[-1]
    lead = tuple(y.shape[:-2])
    yt = y.to(CF32).transpose(-1, -2)                            # [..., K, M]
    vr, vi = dft_rows(yt.real, yt.imag)
    hist = state.tail.reshape(*lead, p - 1, m)
    vin = torch.cat([hist, torch.complex(vr, vi)], dim=-2)       # [..., K+P-1, M]
    fq = h.reshape(p, m)
    ar = ai = None
    for l in range(p):
        seg = vin[..., p - 1 - l:p - 1 - l + kk, :]
        tr, ti = seg.real * fq[l], seg.imag * fq[l]
        ar, ai = (tr, ti) if l == 0 else (ar + tr, ai + ti)
    s = np.float32(m)
    x = torch.complex(ar * s, ai * s).reshape(*lead, kk * m)
    new_tail = vin[..., kk:, :].reshape(*lead, (p - 1) * m)
    return ChannelizerState(tail=new_tail), x


def synthesizer_init(taps, num_channels: int, channel_shape: tuple = (), dtype=CF32,
                     device=None) -> ChannelizerState:
    m = num_channels
    p = pad_prototype(taps, m).shape[0] // m
    return ChannelizerState(tail=torch.zeros((*channel_shape, (p - 1) * m), dtype=dtype,
                                             device=resolve(device)))


# 2x-oversampled bank: frames advance by M/2 samples, which keeps every
# channel's transition band unaliased at twice the output rate and brings the
# per-frame twiddle (-1)^(m*k) relative to the critically-sampled bank.


def channelize_os2_apply(taps, state: ChannelizerState, x: torch.Tensor, num_channels: int
                         ) -> tuple[ChannelizerState, torch.Tensor]:
    """2x-oversampled analysis. x: [..., N], N % (M/2) == 0 -> [..., M, 2N/M].

    y[..., m, k] = sum_j h[j] x[k*M/2 - j] e^{+j*2*pi*m*j/M} * (-1)^{m*k}
    """
    m = num_channels
    if m % 2 != 0:
        raise ValueError("oversampled bank needs even num_channels")
    st, yr, yi = _analysis(taps, state, x, m, m // 2)
    k = yr.shape[-2]
    odd = torch.arange(k, device=yr.device)[:, None] * torch.arange(m, device=yr.device)[None, :]
    tw = torch.where(odd % 2 == 1, -1.0, 1.0).to(F32)
    return st, torch.complex(yr * tw, yi * tw).transpose(-1, -2).contiguous()


def channelize_os2_full(taps, x: torch.Tensor, num_channels: int) -> torch.Tensor:
    state = channelizer_init(taps, num_channels, channel_shape=tuple(x.shape[:-1]),
                             device=x.device)
    _, y = channelize_os2_apply(taps, state, x, num_channels)
    return y


def synthesize_os2_apply(taps, state: ChannelizerState, y: torch.Tensor, num_channels: int
                         ) -> tuple[ChannelizerState, torch.Tensor]:
    """2x-oversampled synthesis: inverse layout of channelize_os2.

    y: [..., M, K] (K frames at rate 2*fs/M) -> x: [..., K*M/2] wideband.

        x[n] = (2/M) * sum_k f[n - k*M/2] * v_k[n mod M],
        v_k[q] = sum_m y[m, k] (-1)^{m*k} e^{+j*2*pi*m*q/M}

    evaluated per output phase at the low rate; frame k's hop of outputs reads
    phases r (k even) or M/2 + r (k odd). State carries 2P-1 phase frames as
    [..., (2P-1)*M].
    """
    m = num_channels
    hop = m // 2
    h, _, p = _proto(taps, m, y.device)
    kk = y.shape[-1]
    lead = tuple(y.shape[:-2])
    yt = y.to(CF32).transpose(-1, -2)                            # [..., K, M]
    vr, vi = dft_rows(yt.real, yt.imag)
    lags = 2 * p
    hist = state.tail.reshape(*lead, lags - 1, m)
    vin = torch.cat([hist, torch.complex(vr, vi)], dim=-2)       # [..., K + 2P - 1, M]
    fmat = h.reshape(lags, hop)                                  # f[l*hop + r]
    acc = {}
    for name, cols in (("e", slice(0, hop)), ("o", slice(hop, m))):
        ar = ai = None
        for l in range(lags):
            seg = vin[..., lags - 1 - l:lags - 1 - l + kk, cols]
            tr, ti = seg.real * fmat[l], seg.imag * fmat[l]
            ar, ai = (tr, ti) if l == 0 else (ar + tr, ai + ti)
        acc[name] = (ar, ai)
    even = (torch.arange(kk, device=y.device) % 2 == 0)[:, None]
    s = np.float32(hop)
    out_r = torch.where(even, acc["e"][0], acc["o"][0]) * s
    out_i = torch.where(even, acc["e"][1], acc["o"][1]) * s
    x = torch.complex(out_r, out_i).reshape(*lead, kk * hop)
    new_tail = vin[..., kk:, :].reshape(*lead, (lags - 1) * m)
    return ChannelizerState(tail=new_tail), x


def synthesizer_os2_init(taps, num_channels: int, channel_shape: tuple = (), dtype=CF32,
                         device=None) -> ChannelizerState:
    m = num_channels
    p = pad_prototype(taps, m).shape[0] // m
    return ChannelizerState(tail=torch.zeros((*channel_shape, (2 * p - 1) * m), dtype=dtype,
                                             device=resolve(device)))
