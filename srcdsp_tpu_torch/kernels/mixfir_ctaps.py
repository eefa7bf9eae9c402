"""Complex-taps mix + FIR + decimate, kernel K4 (counterpart of
``srcdsp_tpu/kernels/mixfir_ctaps.py``): the NCO folded into the filter.

    y[J] = sum_a h[a] x[J*M + H - a] e^{j phi(J*M + H - a)}
         = e^{j phi(J*M + H)} * sum_a (h[a] e^{-j a dtheta}) x[J*M + H - a]

The tuning word `dword` is fixed when the kernel is built: the complex taps
g = h e^{-j a dtheta} are made on the host in float64, as the JAX kernel makes
them, and only one phasor per output remains, from the exact u32 word
``word0 + (J*M + H)*dword``. word0 stays a run-time value, so chunked
streaming launches join bit for bit. Output matches K1 (``kernels/mixfir``)
to float32 rounding, not to the bit.

The TPU kernel's banded-Toeplitz packing and 3-matmul Gauss form are matrix-
unit lowerings; the CUDA kernel (``csrc/ctaps.cu``) computes the sum
directly, on the register ring of ``csrc/fir_ring.cuh`` with complex taps: a
block owns 1024 consecutive outputs of [NT, OT] (several rows), each thread 4
of them. Its ownership and index map are mirrored here (`ctaps_shape`,
`ctaps_geometry`, `ctaps_word`, with the ring's `fir_*` of ``kernels/mixfir``)
and checked in numpy by ``tests/test_torch_ctaps.py``. On a CPU tensor the
wrapper runs `mix_fir_ctaps_plain`.

bf16 ingest (``in_dtype=torch.bfloat16``): x ships as bf16 and is converted to
f32 once; taps, sums and outputs stay f32. The JAX variant also rounds its
packed taps to bf16 (a constraint of its matrix-unit lowering), so the port
is held to the reference's contract for this variant, SNR > 30 dB against the
f32 output, not to its bits.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable

import torch

from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.kernels import _build
from srcdsp_tpu_torch.kernels.fsk_ctaps import ctaps_fir_rows, ctaps_host
from srcdsp_tpu_torch.kernels.mixfir import (
    LANE, _round_up, check_in_dtype, check_planes, ctaps_shape, cuda_or_cpu, fir_geometry,
    signed_phase_angle)
from srcdsp_tpu_torch.ops.nco import MASK32, word_tensor

__all__ = ["CtapsKernel", "make_mix_fir_ctaps_kernel", "mix_fir_ctaps",
           "mix_fir_ctaps_plain", "ctaps_shape", "ctaps_geometry", "ctaps_word", "kernel_info"]

# The complex ring's ownership and phasor words (csrc/ctaps.cu on
# csrc/fir_ring.cuh), mirrored item by item; the ring's index map is
# kernels/mixfir's fir_* with shape=ctaps_shape(decim).
SOURCES = {"planes": 0, "frames": 1, "split": 2}


def ctaps_geometry(decim: int, num_taps: int, hist: int) -> tuple[int, int, int, int]:
    """ctaps.cu:60 ring_geometry with CtapsShape: (tp, lead, span, plane)."""
    return fir_geometry(decim, num_taps, hist, ctaps_shape(decim))


def ctaps_blocks(total: int, decim: int) -> int:
    """ctaps.cu:97: blocks of a launch over `total` = NT*OT outputs."""
    return -(-total // ctaps_shape(decim).outputs)


def ctaps_word(word0: int, dword: int, j, decim: int, hist: int):
    """ctaps.cu:79: the u32 phase word of output j's phasor,
    w0 + (j*decim + hist)*dword mod 2^32 (j an int or an int64 array)."""
    return (word0 + (((j * decim + hist) & MASK32) * dword)) & MASK32


def kernel_info(source: str, decim: int, num_taps: int, hist: int, bf16: bool = False
                ) -> tuple[int, int, int]:
    """(registers, local-memory bytes, resident blocks per SM) of the K4
    ("planes"), K5 ("frames") or K17 ("split") instantiation that runs
    `decim` (on the card)."""
    out = [ctypes.c_int(0) for _ in range(3)]
    _build.check(_build.load().srcdsp_ctaps_info(SOURCES[source], int(bf16), decim, num_taps,
                                                 hist, *map(ctypes.byref, out)), "ctaps_info")
    return tuple(v.value for v in out)


@dataclasses.dataclass(frozen=True)
class CtapsKernel:
    """Complex-taps kernel + its layout contract (the JAX package's CtapsKernel)."""

    fn: Callable          # (word0, x [2, HK+N]) -> (yr, yi) [NT, OT]
    num_taps: int
    decim: int
    out_tile: int
    b_rows: int
    hist: int
    dword: int            # baked tuning word (u32)

    def block_in(self) -> int:
        """Input block granularity (N must be a multiple of this)."""
        return self.b_rows * self.out_tile * self.decim


def word_u32(word) -> int:
    """A u32 word given as an int, or as a one-element array or tensor (the
    JAX fn's ``i32[1, 1]`` with the same bits)."""
    return int(word_tensor(word).reshape(-1)[0])


def mix_fir_ctaps_plain(word0, dword: int, x: torch.Tensor, gr: torch.Tensor,
                        gi: torch.Tensor, decim: int, out_tile: int, hist: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K4: x [2, hist+N] (f32 or bf16), g [T] -> yr, yi [NT, OT] f32."""
    ar, ai = ctaps_fir_rows(x[None], gr[None], gi[None], decim, hist)
    ar, ai = ar[0], ai[0]
    o = torch.arange(ar.shape[-1], dtype=torch.int64, device=x.device)
    w = (word_u32(word0) + (o * decim + hist) * word_u32(dword)) & MASK32
    ang = signed_phase_angle(w)
    c, s = torch.cos(ang), torch.sin(ang)
    return (ar * c - ai * s).reshape(-1, out_tile), (ar * s + ai * c).reshape(-1, out_tile)


def make_mix_fir_ctaps_kernel(taps, dword: int, decim: int, out_tile: int = 512,
                              b_rows: int = 32, in_dtype: torch.dtype = torch.float32,
                              device=None) -> CtapsKernel:
    """Build K4 for a FIXED tuning word `dword` (u32).

    fn(word0, x [2, HK+N] of `in_dtype`) -> (yr, yi) [NT, OT] f32. The TPU
    version's block_cols, precision, pipelined and interpret options shape
    only the Pallas lowering and have no counterpart here; b_rows keeps its
    meaning as the input granularity (N % (b_rows*out_tile*decim) == 0).
    """
    bf16 = check_in_dtype(in_dtype)
    counter = "mixfir_ctaps_bf16" if bf16 else "mixfir_ctaps"
    device = resolve(device)
    dword = word_u32(dword)
    gr_np, gi_np, _ = ctaps_host(taps, [dword], decim)
    t = gr_np.shape[-1]
    hist = _round_up(t - 1, LANE)
    block = b_rows * out_tile * decim
    gr = torch.as_tensor(gr_np[0], device=device).contiguous()
    gi = torch.as_tensor(gi_np[0], device=device).contiguous()

    def fn(word0, x):
        n = check_planes(x[None], 1, hist, block, in_dtype)
        if x.device != gr.device:
            raise ValueError(f"x on {x.device}, kernel built for {gr.device}")
        if not cuda_or_cpu(x):
            return mix_fir_ctaps_plain(word0, dword, x, gr, gi, decim, out_tile, hist)
        lib = _build.load()
        nt = n // (out_tile * decim)
        yr = torch.empty((nt, out_tile), dtype=torch.float32, device=x.device)
        yi = torch.empty_like(yr)
        rc = lib.srcdsp_mixfir_ctaps(x.data_ptr(), gr.data_ptr(), gi.data_ptr(),
                                     yr.data_ptr(), yi.data_ptr(), word_u32(word0), dword,
                                     x.shape[-1], nt, out_tile, decim, t, hist, int(bf16),
                                     _build.stream_handle(x))
        _build.check(rc, counter)
        _build.LAUNCHES[counter] += 1
        return yr, yi

    return CtapsKernel(fn=fn, num_taps=t, decim=decim, out_tile=out_tile, b_rows=b_rows,
                       hist=hist, dword=dword)


def mix_fir_ctaps(kernel: CtapsKernel, word0, x_planes: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """x_planes: [2, HK+N] -> planes [1, N/M] (``mix_fir_ctaps_pallas``).
    word0 = start phase word, ``(stream_pos - hist) * dword`` as in K1."""
    yr, yi = kernel.fn(word0, x_planes)
    return yr.reshape(1, -1), yi.reshape(1, -1)
