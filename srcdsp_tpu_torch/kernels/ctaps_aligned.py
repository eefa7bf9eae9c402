"""Complex-taps mix + FIR + decimate with the history as its own operand,
kernel K17 (counterpart of ``srcdsp_tpu/kernels/ctaps_aligned.py``).

K4 (``kernels/mixfir_ctaps``) takes one [2, hist + N] array, so a stream
prepends the last ``hist`` samples of the previous chunk to every chunk: a
copy of the whole chunk. Here the caller passes them as ``x_hist [2, hist]``
beside the chunk ``x_body [2, NT, OT*decim]`` and nothing is concatenated:
the CUDA kernel (``csrc/ctaps.cu``, with the ``Split`` window source of
``csrc/fsk_common.cuh``) reads stream sample g from ``x_hist`` for g < hist
and from the body at g - hist. It is K4's body launched with K4's word
``word0 - hist*dword``, so it gives K4's bits on the same stream in every
column block. The TPU kernel's banded matmuls, its split of column block 0 at
the row boundary and its factored per-output phasor are matrix-unit
lowerings with no counterpart here.

``word0`` is the phase word of body sample 0 (``stream_pos * dword``). On a
CPU tensor the wrapper runs `ctaps_aligned_plain`, K4's plain version over the
concatenated stream.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.kernels import _build
from srcdsp_tpu_torch.kernels.fsk_ctaps import ctaps_host
from srcdsp_tpu_torch.kernels.mixfir import LANE, _round_up, check_f32_operand
from srcdsp_tpu_torch.kernels.mixfir_ctaps import mix_fir_ctaps_plain, word_u32
from srcdsp_tpu_torch.ops.nco import MASK32

__all__ = ["AlignedKernel", "make_ctaps_aligned_kernel", "ctaps_aligned",
           "ctaps_aligned_plain"]


@dataclasses.dataclass(frozen=True)
class AlignedKernel:
    """K17 + its layout contract (the JAX package's AlignedKernel)."""

    fn: Callable          # (word0, x_hist [2, H], x_body [2, NT, ST]) -> (yr, yi) [NT, OT]
    num_taps: int
    decim: int
    out_tile: int
    b_rows: int
    hist: int
    dword: int            # baked tuning word (u32)

    def block_in(self) -> int:
        """Input block granularity (N must be a multiple of this)."""
        return self.b_rows * self.out_tile * self.decim


def k4_word(word0, dword: int, hist: int) -> int:
    """K4's start word for the concatenated stream whose body sample 0 has
    phase word `word0`: ``word0 - hist*dword`` mod 2^32."""
    return (word_u32(word0) - hist * dword) & MASK32


def split_pick(g, hist: int, n: int):
    """fsk_common.cuh:149-176 Split: (operand, index) of stream sample g (an
    int or an int64 array): (0, g) in x_hist for g < hist, (1, g - hist) in
    the body after it, (-1, -1) outside [0, hist + n)."""
    g = np.asarray(g, np.int64)
    ok = (g >= 0) & (g < hist + n)
    which = np.where(ok, (g >= hist).astype(np.int64), -1)
    return which, np.where(ok, np.where(g < hist, g, g - hist), -1)


def ctaps_aligned_plain(word0, dword: int, x_hist: torch.Tensor, x_body: torch.Tensor,
                        gr: torch.Tensor, gi: torch.Tensor, decim: int, out_tile: int,
                        hist: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K17: K4's plain version over ``cat(x_hist, body)``."""
    x = torch.cat([x_hist, x_body.reshape(2, -1)], dim=-1)
    return mix_fir_ctaps_plain(k4_word(word0, dword, hist), dword, x, gr, gi, decim,
                               out_tile, hist)


def make_ctaps_aligned_kernel(taps, dword: int, decim: int, out_tile: int = 512,
                              b_rows: int = 32, block_cols: int = 128,
                              device=None) -> AlignedKernel:
    """Build K17 for a FIXED tuning word `dword` (u32).

    fn(word0, x_hist [2, hist], x_body [2, NT, OT*decim]) -> (yr, yi) [NT, OT]
    f32; each plane must be contiguous, the planes may lie apart (slices of
    one [2, hist + N] array serve as they are). block_cols keeps the
    reference's requirement block_cols*decim >= hist and out_tile %
    block_cols == 0; the TPU version's precision and interpret options shape
    only the Pallas lowering and have no counterpart here.
    """
    device = resolve(device)
    dword = word_u32(dword)
    if out_tile % block_cols != 0:
        raise ValueError(f"out_tile {out_tile} % block_cols {block_cols} != 0")
    gr_np, gi_np, _ = ctaps_host(taps, [dword], decim)
    t = gr_np.shape[-1]
    hist = _round_up(t - 1, LANE)
    if block_cols * decim < hist:
        raise ValueError(f"aligned framing needs block_cols*decim ({block_cols * decim})"
                         f" >= hist ({hist})")
    stride = out_tile * decim
    gr = torch.as_tensor(gr_np[0], device=device).contiguous()
    gi = torch.as_tensor(gi_np[0], device=device).contiguous()

    def fn(word0, x_hist, x_body):
        if x_body.ndim != 3 or x_body.shape[0] != 2 or x_hist.shape != (2, hist):
            raise ValueError(f"x_hist must be [2, {hist}], x_body [2, NT, {stride}]; got "
                             f"{tuple(x_hist.shape)}, {tuple(x_body.shape)}")
        if x_body.shape[-1] != stride:
            raise ValueError(f"x_body last dim must be {stride}, x_hist {hist}; got "
                             f"{x_body.shape[-1]}, {x_hist.shape[-1]}")
        nt = x_body.shape[1]
        if nt == 0 or nt % b_rows != 0:
            raise ValueError(f"NT={nt} not a multiple of {b_rows}")
        on_card = check_f32_operand(x_body, gr.device, "x_body")
        check_f32_operand(x_hist, gr.device, "x_hist")
        if x_hist.stride(-1) != 1 or x_body.stride(-1) != 1 or x_body.stride(1) != stride:
            raise ValueError(f"x_hist and x_body planes must be contiguous, got strides "
                             f"{x_hist.stride()}, {x_body.stride()}")
        if not on_card:
            return ctaps_aligned_plain(word0, dword, x_hist, x_body, gr, gi, decim, out_tile,
                                       hist)
        lib = _build.load()
        yr = torch.empty((nt, out_tile), dtype=torch.float32, device=x_body.device)
        yi = torch.empty_like(yr)
        rc = lib.srcdsp_ctaps_aligned(x_hist.data_ptr(), x_body.data_ptr(), gr.data_ptr(),
                                      gi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
                                      k4_word(word0, dword, hist), dword, x_hist.stride(0),
                                      x_body.stride(0), nt * stride, nt, out_tile, decim, t,
                                      hist, _build.stream_handle(x_body))
        _build.check(rc, "ctaps_aligned")
        _build.LAUNCHES["ctaps_aligned"] += 1
        return yr, yi

    return AlignedKernel(fn=fn, num_taps=t, decim=decim, out_tile=out_tile, b_rows=b_rows,
                         hist=hist, dword=dword)


def ctaps_aligned(kernel: AlignedKernel, word0, x_hist: torch.Tensor, x_body: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """x_hist [2, hist] (zeros at stream start, then the previous chunk's last
    hist samples), x_body [2, N] with N % block_in() == 0, viewed as [2, NT,
    OT*decim] without a copy -> planes [1, N/decim] (``ctaps_aligned_pallas``).
    word0 = phase word of x_body[:, 0] (stream_pos * dword)."""
    stride = kernel.out_tile * kernel.decim
    yr, yi = kernel.fn(word0, x_hist, x_body.view(2, -1, stride))
    return yr.reshape(1, -1), yi.reshape(1, -1)
