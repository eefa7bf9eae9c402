"""Four-step (Bailey) FFT as two DFT matrix products (counterpart of
``srcdsp_tpu/ops/fft_planes.py``).

A length-N FFT with N = N1*N2 factors into

    X[k1 + N1*k2] = sum_{n2} W_N2[k2, n2] * T[n2, k1] ,
    T[n2, k1]     = tw[n2, k1] * sum_{n1} W_N1[k1, n1] * x[n1*N2 + n2] ,
    tw[n2, k1]    = exp(-2*pi*i*n2*k1/N)

over float32 planes: four real matrix products per stage and one elementwise
twiddle, with the JAX package's constants and stage order. The JAX package
leaves these products to XLA outside any kernel, so here they are
``torch.matmul`` in full float32 (``ops.fir.pin_f32`` turns TF32 off on the
card). Output in natural order.
"""

from __future__ import annotations

import numpy as np
import torch

from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.ops.fir import pin_f32


def _dft_planes(n: int) -> tuple[np.ndarray, np.ndarray]:
    """DFT matrix W[k, j] = exp(-2*pi*i*k*j/n) as (real, imag) f32."""
    k = np.arange(n)
    w = np.exp(-2j * np.pi * np.outer(k, k) / n)
    return w.real.astype(np.float32), w.imag.astype(np.float32)


def _twiddle_planes(n1: int, n2: int) -> tuple[np.ndarray, np.ndarray]:
    """tw[n2, k1] = exp(-2*pi*i*n2*k1/(n1*n2)) as (real, imag) f32."""
    t = np.exp(-2j * np.pi * np.outer(np.arange(n2), np.arange(n1)) / (n1 * n2))
    return t.real.astype(np.float32), t.imag.astype(np.float32)


def default_n1(n: int) -> int:
    """The closest-to-square power-of-two factor of n (64 at 4096)."""
    return 1 << ((n.bit_length() - 1) // 2)


def make_fft_planes(n: int, n1: int | None = None, precision=None, device=None):
    """Build a batched FFT: (xr, xi) [B, N] -> (Xr, Xi) [B, N] float32.

    n must factor as n1*n2 (default: `default_n1`). `precision` is accepted
    for the JAX signature and changes nothing: the products run in full
    float32 at every setting. The constants live on `device` (the card
    unless asked otherwise).
    """
    if n1 is None:
        n1 = default_n1(n)
        if n % n1 != 0:
            raise ValueError(f"cannot auto-factor {n}")
    n2 = n // n1
    if n1 * n2 != n:
        raise ValueError(f"{n} != {n1} * {n2}")
    dev = resolve(device)
    w1r, w1i = (torch.as_tensor(a, device=dev) for a in _dft_planes(n1))
    w2r, w2i = (torch.as_tensor(a, device=dev) for a in _dft_planes(n2))
    twr, twi = (torch.as_tensor(a, device=dev) for a in _twiddle_planes(n1, n2))

    def cmatmul(ar, ai, br, bi):
        """(ar + i*ai) @ (br + i*bi) in planes."""
        return ar @ br - ai @ bi, ar @ bi + ai @ br

    def fft(xr: torch.Tensor, xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        pin_f32(xr)
        b = xr.shape[0]
        # stage 1 contracts n1: rows (b, n2), columns n1 -> k1
        ar = xr.reshape(b, n1, n2).transpose(-1, -2).reshape(b * n2, n1)
        ai = xi.reshape(b, n1, n2).transpose(-1, -2).reshape(b * n2, n1)
        sr, si = cmatmul(ar, ai, w1r.T, w1i.T)                # [B*n2, n1]
        sr, si = sr.reshape(b, n2, n1), si.reshape(b, n2, n1)
        tr = sr * twr - si * twi
        ti = sr * twi + si * twr
        # stage 2 contracts n2: rows (b, k1), columns n2 -> k2
        br_ = tr.transpose(-1, -2).reshape(b * n1, n2)
        bi_ = ti.transpose(-1, -2).reshape(b * n1, n2)
        yr, yi = cmatmul(br_, bi_, w2r.T, w2i.T)              # [B*n1, n2]
        # [B, k1, k2] -> [B, k2, k1]: flat index n1*k2 + k1 = k
        outr = yr.reshape(b, n1, n2).transpose(-1, -2).reshape(b, n)
        outi = yi.reshape(b, n1, n2).transpose(-1, -2).reshape(b, n)
        return outr, outi

    return fft


def fft_planes_flops(batch: int, n: int, n1: int | None = None) -> int:
    """Real-FLOP count of the plane FFT (for GFLOP/s metrics): 4 real
    matmuls of [.., k] per stage * 2 FLOP/MAC + twiddle elementwise."""
    if n1 is None:
        n1 = default_n1(n)
    n2 = n // n1
    stage1 = batch * n2 * n1 * n1 * 8      # 4 matmuls, 2 FLOP each MAC
    stage2 = batch * n1 * n2 * n2 * 8
    tw = batch * n * 6
    return stage1 + stage2 + tw
