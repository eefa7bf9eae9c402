"""Fused NCO-mix + FIR + decimate, kernel K1 (counterpart of
``srcdsp_tpu/kernels/mixfir.py``).

Each input sample is read once, mixed by its exact u32 phase word
``word0 + g*dword`` (g = index into the history-prepended input), and
filtered + decimated in the same pass:

    y[J] = sum_a h[a] * u[J*M + hist - a],   J = row*OT + col

HK (``hist``) is taps-1 rounded up to 128; callers prepend HK history samples
(zeros at stream start), exactly as for the JAX kernel, so both packages take
the same arrays. Output planes are [C, NT, OT].

The CUDA kernel is ``csrc/mixfir.cu``. On a CPU tensor the wrappers run
`mix_fir_plain`, the plain PyTorch version beside it; on a CUDA tensor they
launch the kernel or raise.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.kernels import _build
from srcdsp_tpu_torch.ops.fir import pin_f32
from srcdsp_tpu_torch.ops.nco import MASK32, TWO_PI, _INV_SCALE, word_tensor

LANE = 128


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def toeplitz_taps(taps: np.ndarray, decim: int, out_tile: int,
                  hist: int) -> np.ndarray:
    """H_T[a, j] = h[j*decim + hist - a], zero outside [0, T)."""
    h = np.asarray(taps, np.float32)
    t = h.shape[0]
    span = out_tile * decim + hist
    mat = np.zeros((span, out_tile), np.float32)
    for j in range(out_tile):
        for a in range(t):
            idx = j * decim + hist - a
            if 0 <= idx < span:
                mat[idx, j] = h[a]
    return mat


def banded_taps(taps: np.ndarray, decim: int, out_tile: int, hist: int,
                block_cols: int) -> np.ndarray:
    """Per-block bands of the Toeplitz matrix: [NB, BC*M + hist, BC]."""
    ht = toeplitz_taps(taps, decim, out_tile, hist)
    nb = out_tile // block_cols
    bspan = block_cols * decim + hist
    return np.stack([
        ht[j * block_cols * decim: j * block_cols * decim + bspan,
           j * block_cols: (j + 1) * block_cols]
        for j in range(nb)
    ])


def signed_phase_angle(words: torch.Tensor) -> torch.Tensor:
    """u32 words -> float32 radians, the word read as a signed turn: the
    JAX kernels' int32 phase math, ``float32(int32(word)) * (2*pi/2^32)``."""
    signed = words - ((words >> 31) << 32)
    return signed.to(torch.float32) * np.float32(TWO_PI * _INV_SCALE)


def check_planes(x: torch.Tensor, num_channels: int, hist: int, block: int,
                 in_dtype: torch.dtype = torch.float32) -> int:
    """Validate x [C, 2, hist + N] contiguous, of the kernel's input dtype;
    return N."""
    if x.dtype != in_dtype:
        raise ValueError(f"x dtype {x.dtype} != kernel in_dtype {in_dtype}")
    if x.ndim != 3 or x.shape[0] != num_channels or x.shape[1] != 2:
        raise ValueError(f"x must be [{num_channels}, 2, hist+N], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    n = x.shape[-1] - hist
    if n <= 0 or n % block != 0:
        raise ValueError(f"N={n} not a multiple of kernel block {block}")
    return n


def check_in_dtype(in_dtype: torch.dtype) -> bool:
    """True for a bf16-ingest kernel, False for float32; anything else raises."""
    if in_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"in_dtype must be float32 or bfloat16, got {in_dtype}")
    return in_dtype == torch.bfloat16


def cuda_or_cpu(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); anything else raises."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {x.device}")


def fir_decim_rows(u: torch.Tensor, taps: torch.Tensor, decim: int, hist: int
                   ) -> torch.Tensor:
    """Plain FIR + decimate of history-prepended planes.

    u: [C, P, hist + N] f32; taps [T] (shared) or [C, T].
    Returns [C, P, N/decim] with y[J] = sum_a h[a] u[J*decim + hist - a].
    """
    pin_f32(u)
    c, p, _ = u.shape
    t = taps.shape[-1]
    v = u[..., hist - (t - 1):]                   # first output reads v[0 .. T-1]
    if taps.ndim == 1:
        y = F.conv1d(v.reshape(c * p, 1, -1), taps.flip(-1).reshape(1, 1, t), stride=decim)
    else:
        w = taps.flip(-1).repeat_interleave(p, dim=0).reshape(c * p, 1, t)
        y = F.conv1d(v.reshape(1, c * p, -1), w, stride=decim, groups=c * p)
    return y.reshape(c, p, -1)


def mix_planes(words0, dwords, x: torch.Tensor) -> torch.Tensor:
    """Planes x [C, 2, L] mixed sample by sample by the exact u32 word
    ``words0[c] + g*dwords[c]`` (g = index along L) -> [C, 2, L] float32."""
    _, _, length = x.shape
    g = torch.arange(length, dtype=torch.int64, device=x.device)
    w = (word_tensor(words0, x.device).reshape(-1, 1)
         + g * word_tensor(dwords, x.device).reshape(-1, 1)) & MASK32
    ang = signed_phase_angle(w)
    cs, sn = torch.cos(ang), torch.sin(ang)
    xr, xi = x[:, 0].to(torch.float32), x[:, 1].to(torch.float32)
    return torch.stack([xr * cs - xi * sn, xr * sn + xi * cs], dim=1)


def mix_fir_plain(words0, dwords, x: torch.Tensor, taps: torch.Tensor, decim: int,
                  out_tile: int, hist: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K1: x [C, 2, hist+N], taps [T] or [C, T] -> yr, yi [C, NT, OT]."""
    c = x.shape[0]
    y = fir_decim_rows(mix_planes(words0, dwords, x), taps, decim, hist)
    return y[:, 0].reshape(c, -1, out_tile), y[:, 1].reshape(c, -1, out_tile)


def _words_i32(words, c: int, device) -> torch.Tensor:
    """u32 words as an int32 tensor [C] with the same bits, for the kernel."""
    w = word_tensor(words).reshape(-1).expand(c)
    return (w - ((w >> 31) << 32)).to(torch.int32).to(device).contiguous()


def _mix_fir_cuda(words0, dwords, x: torch.Tensor, taps: torch.Tensor, decim: int,
                  out_tile: int, hist: int, counter: str
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    lib = _build.load()
    c, _, length = x.shape
    nt = (length - hist) // (out_tile * decim)
    w0 = _words_i32(words0, c, x.device)
    dw = _words_i32(dwords, c, x.device)
    yr = torch.empty((c, nt, out_tile), dtype=torch.float32, device=x.device)
    yi = torch.empty_like(yr)
    rc = lib.srcdsp_mixfir(x.data_ptr(), w0.data_ptr(), dw.data_ptr(), taps.data_ptr(),
                           0 if taps.ndim == 1 else taps.shape[-1], yr.data_ptr(),
                           yi.data_ptr(), c, length, nt, out_tile, decim, taps.shape[-1],
                           hist, _build.stream_handle(x))
    _build.check(rc, counter)
    _build.LAUNCHES[counter] += 1
    return yr, yi


@dataclasses.dataclass(frozen=True)
class MixFirKernel:
    """Fused kernel + its layout contract (the JAX package's MixFirKernel)."""

    fn: Callable          # (words0, dwords, x) -> (yr, yi): [NT, OT] (C=1) or [C, NT, OT]
    num_taps: int
    decim: int
    out_tile: int
    b_rows: int
    hist: int             # HK: history samples callers must prepend
    device: torch.device

    def block_in(self) -> int:
        """Input block granularity (N must be a multiple of this)."""
        return self.b_rows * self.out_tile * self.decim


def _make(taps: np.ndarray, decim: int, num_channels: int, out_tile: int, b_rows: int,
          device, counter: str, single: bool) -> MixFirKernel:
    t = taps.shape[-1]
    hist = _round_up(t - 1, LANE)
    block = b_rows * out_tile * decim
    taps_t = torch.as_tensor(taps, device=resolve(device)).contiguous()

    def fn(words0, dwords, x):
        xc = x[None] if single else x
        check_planes(xc, num_channels, hist, block)
        if xc.device != taps_t.device:
            raise ValueError(f"x on {xc.device}, kernel built for {taps_t.device}")
        if cuda_or_cpu(xc):
            yr, yi = _mix_fir_cuda(words0, dwords, xc, taps_t, decim, out_tile, hist, counter)
        else:
            yr, yi = mix_fir_plain(words0, dwords, xc, taps_t, decim, out_tile, hist)
        return (yr[0], yi[0]) if single else (yr, yi)

    return MixFirKernel(fn=fn, num_taps=t, decim=decim, out_tile=out_tile, b_rows=b_rows,
                        hist=hist, device=taps_t.device)


def make_mix_fir_kernel(taps, decim: int, out_tile: int = 512, b_rows: int = 32,
                        device=None) -> MixFirKernel:
    """Single-channel K1: fn(word0, dword, x [2, HK+N]) -> (yr, yi) [NT, OT].

    The TPU version's precision, phasor, pipelined and interpret options shape
    only the Pallas lowering and have no counterpart here; b_rows keeps its
    meaning as the input granularity (N % (b_rows*out_tile*decim) == 0).
    """
    taps = np.asarray(taps, np.float32)
    return _make(taps, decim, 1, out_tile, b_rows, device, "mixfir", single=True)


def make_mix_fir_kernel_mc(taps, decim: int, num_channels: int, out_tile: int = 512,
                           b_rows: int = 8, device=None) -> MixFirKernel:
    """Multichannel K1: fn(words0 [C], dwords [C], x [C, 2, HK+N]) -> [C, NT, OT] x2.

    `taps` is [T] (shared) or [C, T] (one filter per channel).
    """
    taps = np.asarray(taps, np.float32)
    if taps.ndim == 2 and taps.shape[0] != num_channels:
        raise ValueError(f"per-channel taps {taps.shape} != C={num_channels}")
    return _make(taps, decim, num_channels, out_tile, b_rows, device, "mixfir_mc",
                 single=False)


def mix_fir_decim(kernel: MixFirKernel, word0, dword, x_planes: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """x_planes: [2, HK+N] f32 -> planes [1, N/M] (``mix_fir_decim_pallas``)."""
    yr, yi = kernel.fn(word0, dword, x_planes)
    return yr.reshape(1, -1), yi.reshape(1, -1)


def mix_fir_decim_mc(kernel: MixFirKernel, words0, dwords, x_planes: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """x_planes: [C, 2, HK+N] f32; words [C] u32 -> planes [C, N/M]
    (``mix_fir_decim_pallas_mc``)."""
    yr, yi = kernel.fn(words0, dwords, x_planes)
    c = yr.shape[0]
    return yr.reshape(c, -1), yi.reshape(c, -1)
