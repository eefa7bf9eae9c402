"""Row-form fused NCO mix + FIR + decimate, kernel K18 (counterpart of
``srcdsp_tpu/kernels/mixfir_rows.py``).

The history-prepended planes are viewed as [2, R, 128] rows. Because
OT*decim is a multiple of 128, every output row's window is whole rows of
that view. Each input sample is mixed once, by the factored phasor

    e^{j 2 pi (word0 + (row*128 + lane)*dword) / 2^32}
      = e^{j 2 pi (word0 + row*128*dword) / 2^32} * e^{j 2 pi lane*dword / 2^32}

(two phasors per 128 samples where K1 makes one per sample), with the row
words in u32 wrap, the JAX kernel's int32 wrap. The FIR is K1's real-tap sum.
The CUDA kernel is ``csrc/rows.cu``; the TPU kernel's chunked [B, 128] x
[128, BC] matmuls are a matrix-unit lowering with no counterpart here. The
output equals K1's to float32 rounding of the phasor product, not to the bit.
On a CPU tensor the wrapper runs `mix_fir_rows_plain`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.kernels import _build
from srcdsp_tpu_torch.kernels.mixfir import (
    LANE, _round_up, check_f32_operand, fir_decim_rows, signed_phase_angle)
from srcdsp_tpu_torch.kernels.mixfir_ctaps import word_u32
from srcdsp_tpu_torch.ops.nco import MASK32

__all__ = ["MixFirRowsKernel", "make_mix_fir_rows_kernel", "mix_fir_rows",
           "mix_fir_rows_plain", "rows_view"]


@dataclasses.dataclass(frozen=True)
class MixFirRowsKernel:
    """K18 + its layout contract (the JAX package's MixFirRowsKernel)."""

    fn: Callable          # (word0, dword, x [2, R, 128], n=None) -> (yr, yi) [NT, OT]
    num_taps: int
    decim: int
    out_tile: int
    b_rows: int
    hist: int

    def block_in(self) -> int:
        """Input block granularity (N must be a multiple of this)."""
        return self.b_rows * self.out_tile * self.decim


def mix_fir_rows_plain(word0, dword, x: torch.Tensor, taps: torch.Tensor, decim: int,
                       out_tile: int, hist: int, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K18: the factored phasor over x [2, R, 128], then the
    real-tap FIR of the first hist + n samples -> yr, yi [NT, OT]."""
    dw = word_u32(dword)
    rows = torch.arange(x.shape[1], dtype=torch.int64, device=x.device)
    lanes = torch.arange(LANE, dtype=torch.int64, device=x.device)
    ra = signed_phase_angle((word_u32(word0) + rows * ((LANE * dw) & MASK32)) & MASK32)[:, None]
    la = signed_phase_angle((lanes * dw) & MASK32)[None, :]
    crow, srow, clane, slane = torch.cos(ra), torch.sin(ra), torch.cos(la), torch.sin(la)
    c = crow * clane - srow * slane
    s = crow * slane + srow * clane
    xr, xi = x[0], x[1]
    u = torch.stack([xr * c - xi * s, xr * s + xi * c]).reshape(2, -1)[:, :hist + n]
    y = fir_decim_rows(u[None], taps, decim, hist)[0]
    return y[0].reshape(-1, out_tile), y[1].reshape(-1, out_tile)


def make_mix_fir_rows_kernel(taps, decim: int, out_tile: int = 512, b_rows: int = 32,
                             block_cols: int = 128, device=None) -> MixFirRowsKernel:
    """Build K18: fn(word0, dword, x [2, R, 128] f32, n=None) -> (yr, yi) [NT, OT].

    Keeps the reference's layout contract: out_tile*decim and
    block_cols*decim multiples of 128, out_tile % block_cols == 0, N a
    multiple of b_rows*out_tile*decim, and R at least the rows its last slab
    would read (pad the tail; `mix_fir_rows` does). n defaults to R*128 -
    hist. The TPU version's precision and interpret options shape only the
    Pallas lowering and have no counterpart here.
    """
    taps_t = torch.as_tensor(np.asarray(taps, np.float32), device=resolve(device)).contiguous()
    if (out_tile * decim) % LANE != 0:
        raise ValueError(f"out_tile*decim must be a multiple of {LANE}")
    if (block_cols * decim) % LANE != 0:
        raise ValueError(f"block_cols*decim must be a multiple of {LANE}")
    if out_tile % block_cols != 0:
        raise ValueError(f"out_tile {out_tile} % block_cols {block_cols}")
    t = taps_t.shape[0]
    hist = _round_up(t - 1, LANE)
    span = out_tile * decim + hist
    rs8 = (out_tile * decim) // LANE
    slab_rows = _round_up((b_rows - 1) * rs8 + span // LANE + 1, math.lcm(8, rs8))

    def fn(word0, dword, x, n=None):
        two, r, lane = x.shape
        if two != 2 or lane != LANE:
            raise ValueError(f"x must be [2, R, {LANE}], got {tuple(x.shape)}")
        if n is None:
            n = r * LANE - hist     # no tail padding
        block = b_rows * out_tile * decim
        if n <= 0 or n % block != 0:
            raise ValueError(f"N={n} not a multiple of {block}")
        nt = n // (out_tile * decim)
        grid = nt // b_rows
        if (grid - 1) * b_rows * rs8 + slab_rows > r:
            raise ValueError(f"need R >= {(grid - 1) * b_rows * rs8 + slab_rows} rows "
                             f"(pad the tail), got {r}")
        if not check_f32_operand(x, taps_t.device, "x"):
            return mix_fir_rows_plain(word0, dword, x, taps_t, decim, out_tile, hist, n)
        if not x.is_contiguous():
            raise ValueError("x must be contiguous")
        lib = _build.load()
        yr = torch.empty((nt, out_tile), dtype=torch.float32, device=x.device)
        yi = torch.empty_like(yr)
        rc = lib.srcdsp_mixfir_rows(x.data_ptr(), taps_t.data_ptr(), yr.data_ptr(),
                                    yi.data_ptr(), word_u32(word0), word_u32(dword), r * LANE,
                                    nt, out_tile, decim, t, hist, _build.stream_handle(x))
        _build.check(rc, "mixfir_rows")
        _build.LAUNCHES["mixfir_rows"] += 1
        return yr, yi

    return MixFirRowsKernel(fn=fn, num_taps=t, decim=decim, out_tile=out_tile,
                            b_rows=b_rows, hist=hist)


def rows_view(kernel: MixFirRowsKernel, x_planes: torch.Tensor) -> tuple[torch.Tensor, int]:
    """x_planes [2, HK+N] -> (x [2, R, 128], N): the tail zero-padded to the
    kernel's slab-row rounding, as ``mix_fir_rows_pallas`` pads it."""
    total = x_planes.shape[-1]
    n = total - kernel.hist
    rs8 = (kernel.out_tile * kernel.decim) // LANE
    span_rows = (kernel.out_tile * kernel.decim + kernel.hist) // LANE
    grid = n // kernel.block_in()
    need_rows = _round_up((grid - 1) * kernel.b_rows * rs8
                          + _round_up((kernel.b_rows - 1) * rs8 + span_rows + 1, 8), 8)
    pad = need_rows * LANE - total
    if pad > 0:
        x_planes = torch.cat([x_planes, x_planes.new_zeros((2, pad))], dim=-1)
    return x_planes.reshape(2, -1, LANE), n


def mix_fir_rows(kernel: MixFirRowsKernel, word0, dword, x_planes: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """x_planes [2, HK+N] f32 -> planes [1, N/M] (``mix_fir_rows_pallas``)."""
    x3, n = rows_view(kernel, x_planes)
    yr, yi = kernel.fn(word0, dword, x3, n=n)
    return yr.reshape(1, -1), yi.reshape(1, -1)
