"""Plane-form fused mix+FIR+decimate (counterpart of ``srcdsp_tpu/ops/planes.py``).

Complex I/Q is carried as two float32 planes; the NCO phase is u32 modular
arithmetic (int64 masked to 32 bits) on an index ramp, bit-exact with
``ops.nco`` across any block split; the decimating FIR runs in the
phase-transposed layout A[p, j] = u[j*M + p]:

    y[k] = sum_p sum_s h[s*M - p] * A[p, k + Hm - s]

i.e. S ~= T/M + 1 shifted multiply-accumulates of [M, K] tiles finished by
one column sum. History is carried explicitly as the leading
H = plane_hist_len(T, M) samples of the input. This is the plain tier the
fused kernel (``kernels/mixfir.py``) is held against.
"""

from __future__ import annotations

import numpy as np
import torch

from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.ops.nco import MASK32, TWO_PI, _INV_SCALE, word_tensor
from srcdsp_tpu_torch.types import F32, _f32


def plane_hist_shifts(num_taps: int, decim: int) -> int:
    """Number of shifted MACs S: coefficients h[s*M - p] exist for s < S."""
    return (num_taps - 1 + (decim - 1)) // decim + 1


def plane_hist_len(num_taps: int, decim: int) -> int:
    """History samples H = (S-1)*M carried ahead of each block (mult. of M)."""
    return (plane_hist_shifts(num_taps, decim) - 1) * decim


def phase_coef_matrix(taps, decim: int) -> np.ndarray:
    """coef[p, s] = h[s*M - p] (0 outside range): host-side, once per chain."""
    h = np.asarray(taps, np.float32)
    t = h.shape[0]
    s_max = plane_hist_shifts(t, decim)
    coef = np.zeros((decim, s_max), np.float32)
    for p in range(decim):
        for s in range(s_max):
            a = s * decim - p
            if 0 <= a < t:
                coef[p, s] = h[a]
    return coef


def planes_from_int16(iq: torch.Tensor, scale: float = 32767.0
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Interleaved int16 IQ [..., 2N] -> f32 planes ([..., N], [..., N]).

    Same y = x/scale semantics as types.int16_to_complex64.
    """
    if iq.shape[-1] % 2:
        raise ValueError(f"interleaved IQ length must be even, got {tuple(iq.shape)}")
    de = iq.reshape(*iq.shape[:-1], iq.shape[-1] // 2, 2)
    s = _f32(scale, iq)
    return de[..., 0].to(F32) / s, de[..., 1].to(F32) / s


def nco_planes(word0, dword, n: int, row_offset: int = 0, device=None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin planes [1, n] of the NCO phasor from the u32 accumulator.

    Bit-exact with ops.nco.nco_phasor phase words; row_offset shifts the
    sample index (for chunked calls).
    """
    device = resolve(device)
    k = torch.arange(n, dtype=torch.int64, device=device)[None] + row_offset
    ph = (word_tensor(word0, device) + k * word_tensor(dword, device)) & MASK32
    ang = ph.to(F32) * np.float32(TWO_PI * _INV_SCALE)
    return torch.cos(ang), torch.sin(ang)


def mix_planes(xr, xi, c, s):
    """(xr + j xi) * (c + j s) in planes."""
    return xr * c - xi * s, xr * s + xi * c


def fir_decim_planes(coef: torch.Tensor, xr: torch.Tensor, xi: torch.Tensor,
                     decim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Decimating FIR on history-prepended planes.

    coef: [M, S] from phase_coef_matrix. xr/xi: [1, H + N] with
    H = (S-1)*M history samples (zeros at stream start), N % M == 0.
    Returns planes [1, N // M].
    """
    coef = torch.as_tensor(coef, device=xr.device)
    m, s_max = coef.shape
    hm = s_max - 1
    cols = xr.shape[-1] // m
    k = cols - hm

    def one(x):
        a = x.reshape(cols, m).T                      # [M, Hm + K]
        acc = torch.zeros((m, k), dtype=F32, device=x.device)
        for s in range(s_max):
            acc = acc + coef[:, s:s + 1] * a[:, hm - s: hm - s + k]
        return torch.sum(acc, dim=0, keepdim=True)    # [1, K]

    return one(xr), one(xi)


def fused_mix_fir_decim_planes(coef, word0, dword, xr: torch.Tensor, xi: torch.Tensor,
                               decim: int, row_offset: int = 0
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """NCO mix then decimating FIR, one pass. xr/xi: [1, H+N] planes.

    The history region is mixed too, so `row_offset` indexes the FIRST
    history sample. Output: planes [1, N // M].
    """
    c, s = nco_planes(word0, dword, xr.shape[-1], row_offset, device=xr.device)
    mr, mi = mix_planes(xr, xi, c, s)
    return fir_decim_planes(coef, mr, mi, decim)
