"""Polyphase channelizer as shifted matmuls on planes (counterpart of
``srcdsp_tpu/ops/channelize_planes.py``).

With X2 = x reshaped [K, M] (row k = samples kM..kM+M-1) and S_r = X2
shifted down r rows, the fold + DFT collapses into

    Y[k, m] = sum_r ( S_r @ E_r )[k, m],     r = 0..P

where E_r = A_r @ W folds the polyphase coefficients A_r (A_r[0, 0] = h[rM],
A_r[c, M-c] = h[rM - c] for c >= 1) into the channel DFT
W[p, m] = exp(+j*2*pi*m*p/M). The E_r are built in float64 with numpy and
rounded to float32 once, in the reference's order, so they equal the JAX
package's bit for bit. The runtime is one plain wide ``torch.matmul`` (float32,
TF32 off), as the reference leaves it to XLA.
"""

from __future__ import annotations

import numpy as np
import torch

from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.ops.fir import pin_f32


def make_channelizer_mats(taps, num_channels: int) -> tuple[np.ndarray, np.ndarray]:
    """Baked E_r planes: returns (Er_real, Er_imag), each [P+1, M, M]."""
    m = num_channels
    h = np.asarray(taps, np.float64)
    t = ((len(h) + m - 1) // m) * m
    h = np.pad(h, (0, t - len(h)))
    p = t // m
    w = np.exp(2j * np.pi * np.outer(np.arange(m), np.arange(m)) / m)  # [p, ch]
    ers, eis = [], []
    for r in range(p + 1):
        a = np.zeros((m, m))
        if r * m < t:
            a[0, 0] = h[r * m]
        for c in range(1, m):
            idx = r * m - c
            if 0 <= idx < t:
                a[c, m - c] = h[idx]
        e = a @ w
        ers.append(e.real.astype(np.float32))
        eis.append(e.imag.astype(np.float32))
    return np.stack(ers), np.stack(eis)


def combined_matrix(er: np.ndarray, ei: np.ndarray) -> np.ndarray:
    """[[Er | Ei], [-Ei | Er]] over the row-stacked E_r: [2L, 2M], L = R*M'."""
    r, a, b = er.shape
    er_s, ei_s = er.reshape(r * a, b), ei.reshape(r * a, b)
    return np.block([[er_s, ei_s], [-ei_s, er_s]])


def _shifted(x2: torch.Tensor, count: int) -> torch.Tensor:
    """[K, W] -> [K, count*W]: x2 and its copies shifted down 1..count-1 rows
    (zeros shifted in from the top: causal from rest)."""
    k, w = x2.shape
    cols = [x2]
    for r in range(1, count):
        cols.append(torch.cat([x2.new_zeros((min(r, k), w)), x2[:max(k - r, 0)]], dim=0))
    return torch.cat(cols, dim=1)


def make_channelize_planes(taps, num_channels: int, device=None):
    """Build the plane bank: (xr, xi) [K*M] planes -> (Yr, Yi) [K, M].

    Output Y[k, m] is channel m, frame k (``chains.channelizer`` layout
    transposed). Rows shifted past the start read zeros (causal from rest);
    streaming callers prepend P rows (P*M samples) of history instead.
    """
    er_np, ei_np = make_channelizer_mats(taps, num_channels)
    p1 = er_np.shape[0]
    m = num_channels
    # one matmul for the whole complex bank: shifted copies of both planes
    # stacked horizontally ([K, 2L]) against [[Er | Ei], [-Ei | Er]] ([2L, 2M])
    e_comb = torch.as_tensor(combined_matrix(er_np, ei_np), device=resolve(device))

    def bank(xr: torch.Tensor, xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        pin_f32(xr)
        k = xr.shape[-1] // m
        ss = torch.cat([_shifted(xr.reshape(k, m), p1), _shifted(xi.reshape(k, m), p1)], dim=1)
        y = ss @ e_comb                                            # [K, 2M]
        return y[:, :m], y[:, m:]

    return bank


def make_channelizer_os2_mats(taps, num_channels: int) -> tuple[np.ndarray, np.ndarray]:
    """E_r for the 2x-oversampled bank: [R, M/2, M] planes.

    Frames advance hop = M/2 samples, so with X2 = x reshaped [K2, hop],
    sample x[k*hop - (l*M + p)] lands in row k-r, where

        p = 0:          r = 2l,   col 0
        1 <= p < hop:   r = 2l+1, col hop-p
        p = hop:        r = 2l+1, col 0
        hop < p < M:    r = 2l+2, col 2*hop-p

    giving placement matrices A_r[col, p] folded with the channel DFT.
    """
    m = num_channels
    hop = m // 2
    h = np.asarray(taps, np.float64)
    t = ((len(h) + m - 1) // m) * m
    hp = np.pad(h, (0, t - len(h)))
    p_taps = t // m
    w = np.exp(2j * np.pi * np.outer(np.arange(m), np.arange(m)) / m)
    r_max = 2 * p_taps + 1
    ers, eis = [], []
    for r in range(r_max):
        a = np.zeros((hop, m))
        if r % 2 == 0:
            l = r // 2
            if l * m < t:
                a[0, 0] = hp[l * m]
            if r >= 2:
                l2 = (r - 2) // 2
                for c in range(1, hop):
                    k = l2 * m + m - c
                    if 0 <= k < t:
                        a[c, m - c] = hp[k]
        else:
            l = (r - 1) // 2
            k = l * m + hop
            if k < t:
                a[0, hop] = hp[k]
            for c in range(1, hop):
                k = l * m + hop - c
                if 0 <= k < t:
                    a[c, hop - c] = hp[k]
        e = a @ w   # A_r [hop, p] folded with W[p, ch]
        ers.append(e.real.astype(np.float32))
        eis.append(e.imag.astype(np.float32))
    return np.stack(ers), np.stack(eis)


def make_channelize_os2_planes(taps, num_channels: int, device=None):
    """Plane 2x-oversampled analysis: (xr, xi) [K2*hop] -> (Yr, Yi) [K2, M]
    at frame rate 2*fs/M, including the (-1)^{m*k} parity twiddle (K2 even)."""
    er_np, ei_np = make_channelizer_os2_mats(taps, num_channels)
    r_max = er_np.shape[0]
    m = num_channels
    hop = m // 2
    e_comb = torch.as_tensor(combined_matrix(er_np, ei_np), device=resolve(device))
    tw2 = np.ones((2, m), np.float32)
    tw2[1, 1::2] = -1.0
    tw2 = torch.as_tensor(tw2, device=e_comb.device)

    def bank(xr: torch.Tensor, xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        pin_f32(xr)
        k = xr.shape[-1] // hop
        ss = torch.cat([_shifted(xr.reshape(k, hop), r_max),
                        _shifted(xi.reshape(k, hop), r_max)], dim=1)
        y = ss @ e_comb
        tw = tw2.repeat(k // 2, 1)
        return y[:, :m] * tw, y[:, m:] * tw

    return bank


def make_synthesizer_mats(taps, num_channels: int) -> tuple[np.ndarray, np.ndarray]:
    """Synthesis E_l[m, q] = e^{+j*2*pi*m*q/M} * h[l*M + q] * M: [P, M, M]."""
    m = num_channels
    h = np.asarray(taps, np.float64)
    t = ((len(h) + m - 1) // m) * m
    h = np.pad(h, (0, t - len(h)))
    p = t // m
    wc = np.exp(2j * np.pi * np.outer(np.arange(m), np.arange(m)) / m)
    ers, eis = [], []
    for l in range(p):
        e = wc * (h[l * m: (l + 1) * m][None, :]) * m
        ers.append(e.real.astype(np.float32))
        eis.append(e.imag.astype(np.float32))
    return np.stack(ers), np.stack(eis)


def make_synthesize_planes(taps, num_channels: int, device=None):
    """Plane synthesis bank: (Yr, Yi) [K, M] frames x channels -> wideband
    planes ([K*M], [K*M]),

        x[s*M + q] = M * sum_l h[l*M+q] * (Y @ Wc)[s-l, q]

    the mirror of `make_channelize_planes`: shifted frame copies against the
    stacked E_l, one wide matmul, from zero state."""
    er_np, ei_np = make_synthesizer_mats(taps, num_channels)
    p = er_np.shape[0]
    m = num_channels
    e_comb = torch.as_tensor(combined_matrix(er_np, ei_np), device=resolve(device))

    def synth(yr: torch.Tensor, yi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        pin_f32(yr)
        k = yr.shape[0]
        x = torch.cat([_shifted(yr, p), _shifted(yi, p)], dim=1) @ e_comb   # [K, 2M]
        return x[:, :m].reshape(k * m), x[:, m:].reshape(k * m)

    return synth
