"""Fused overlap-save FFT convolution, kernel K11 (counterpart of
``srcdsp_tpu/kernels/fftconv_pallas.py``).

Layout contract, the reference's: the caller prepends `overlap` history
samples to each channel's planes (zeros at stream start) and passes
x [C, 2, overlap + N] (or its free reshape [C, 2, R, n2]) with N a multiple
of `block_in()`; the output is the causal FIR, planes [C, N]. The geometry
is the JAX kernel's:

    n1 = fft_size / n2,  ov_rows = ceil((T-1)/n2), raised until (n1 - ov_rows) % 8 == 0,
    hs = n1 - ov_rows,   hop = hs * n2,   overlap = ov_rows * n2,   block_in = b_frames * hop

(overlap 1024 and hop 3072 at 1024 taps and fft 4096; `ops.fftconv` takes
hop 3073 there and `ops.fftconv_planes` 2048). Frame f covers samples
[f*hop, f*hop + fft_size) of the history-prepended stream and gives outputs
[f*hop, (f+1)*hop).

On the card the body is K10's for the same size (`fft_plan`). At a power
of two from 256 to 8192 (``csrc/fftconv.cu``) each frame runs K10's
register-resident Stockham schedule (``csrc/fft_regs.cuh``, twiddles from
`stockham_twiddles`) twice: forward, times H[c] in registers (register s of
thread t holds X[t + T*s], so H stays in natural order), the conjugate
inverse, and the registers past the overlap stored. At the other sizes up
to 16384 (``csrc/fft_mixed.cu``, one block a frame, N = P M) the forward
of ``csrc/fft_lines.cuh`` (the odd pass, then the Stockham sub-transforms)
leaves X[k_p + P k_m] in register s of thread (k_p, t), k_m = t + (M/16) s;
H is laid out once in that order (`fft_pallas._forward_order`) and read
coalesced, and the conjugate inverse runs in the transposed order (the
sub-transforms on the registers as they lie, then the odd pass), which
leaves natural order; from 17408 (``csrc/fft_4step.cu``) three kernels over
two scratch buffers: the forward columns, then for each column c the
forward rows, H, the inverse's rows and W_N^{c e}, then the inverse's
columns and the store (a line no register shape holds on a Bluestein line
of ``csrc/fft_lines.cuh``). H is the FFT of the taps zero-padded to fft_size,
made in float64 and rounded to float32 ([Ct, 2, N]; Ct = 1 for shared taps
or C), natural order but for the one-block body.
On a CPU tensor the wrappers run `fftconv_plain` (the same frames through
the float32 matrix FFT of ``ops.fft_planes``, times H, the conjugate
inverse, the overlap prefix dropped); on a CUDA tensor they launch the
kernel or raise.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable

import numpy as np
import torch

from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.kernels import _build
from srcdsp_tpu_torch.kernels.fft_pallas import (FftPlan, fft_plan, line_args, regs_plan,
                                                  scratch_frames, table_ptrs)
from srcdsp_tpu_torch.kernels.mixfir import LANE, _round_up, cuda_or_cpu
from srcdsp_tpu_torch.ops.fft_planes import make_fft_planes

__all__ = ["FftConvKernel", "FftConvStream", "fftconv_geometry", "fftconv_pallas",
           "fftconv_plain", "freq_response_planes", "kernel_info", "make_fftconv_kernel"]


def fftconv_geometry(num_taps: int, fft_size: int, n2: int = LANE) -> tuple[int, int, int]:
    """(n1, ov_rows, hs) of the JAX kernel: the overlap covers num_taps - 1
    in whole rows of n2, and the hop's row count is a multiple of 8."""
    if fft_size % n2 != 0:
        raise ValueError(f"fft_size {fft_size} % n2 {n2} != 0")
    n1 = fft_size // n2
    ov_rows = _round_up(num_taps - 1, n2) // n2
    while (n1 - ov_rows) % 8 != 0 and ov_rows < n1:
        ov_rows += 1
    hs = n1 - ov_rows
    if hs <= 0:
        raise ValueError(f"taps {num_taps} leave no hop in fft_size {fft_size}")
    return n1, ov_rows, hs


def freq_response_planes(taps: np.ndarray, fft_size: int) -> np.ndarray:
    """H as float32 planes [Ct, 2, N] (Ct = 1 for taps [T], C for [C, T]):
    ``np.fft.fft`` of the float64 taps, rounded once."""
    h = np.fft.fft(np.atleast_2d(np.asarray(taps, np.float64)), n=fft_size, axis=-1)
    return np.stack([h.real, h.imag], axis=1).astype(np.float32)


def fftconv_plain(x: torch.Tensor, h2: torch.Tensor, fft, fft_size: int, hop: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K11: x [C, 2, overlap + F*hop] -> (yr, yi) [C, F*hop].

    Frames at stride hop (an unfold), `fft` (the float32 matrix FFT of
    ``ops.fft_planes``) forward, times H (h2 [Ct, 2, N]), the inverse as
    conj(fft(conj(.)))/N, and the first overlap samples of each frame dropped.
    Every frame goes through the same arithmetic wherever a chunk starts.
    """
    c = x.shape[0]
    frames = x.unfold(-1, fft_size, hop)                 # [C, 2, F, N]
    nf = frames.shape[2]
    sr, si = fft(frames[:, 0].reshape(-1, fft_size), frames[:, 1].reshape(-1, fft_size))
    sr, si = sr.reshape(c, nf, fft_size), si.reshape(c, nf, fft_size)
    hr, hi = h2[:, 0, None], h2[:, 1, None]              # [Ct, 1, N]
    pr = sr * hr - si * hi
    pi = sr * hi + si * hr
    tr, ti = fft(pr.reshape(-1, fft_size), -pi.reshape(-1, fft_size))
    inv_n = np.float32(1.0 / fft_size)
    overlap = fft_size - hop
    yr = (tr * inv_n).reshape(c, nf, fft_size)[..., overlap:]
    yi = (-ti * inv_n).reshape(c, nf, fft_size)[..., overlap:]
    return yr.reshape(c, nf * hop), yi.reshape(c, nf * hop)


def _fftconv_cuda(x: torch.Tensor, hk: torch.Tensor, tables: tuple, plan: FftPlan, hop: int,
                  per_channel: bool, counter: str) -> tuple[torch.Tensor, torch.Tensor]:
    lib = _build.load()
    tw, offs = tables
    c, _, length = x.shape
    n = plan.fft_size
    nf = (length - (n - hop)) // hop
    yr = torch.empty((c, nf * hop), dtype=torch.float32, device=x.device)
    yi = torch.empty_like(yr)
    stream = _build.stream_handle(x)
    ptrs = (x.data_ptr(), hk.data_ptr())
    if plan.body == "regs":
        rc = lib.srcdsp_fftconv(*ptrs, tw.data_ptr(), yr.data_ptr(), yi.data_ptr(), c, length,
                                nf, hop, plan.log2n, int(per_channel), stream)
        launches = {counter: 1}
    elif plan.body == "mixed":
        g = plan.lines[0]
        rc = lib.srcdsp_fftconv_mixed(*ptrs, tw.data_ptr(), yr.data_ptr(), yi.data_ptr(), c,
                                      length, nf, hop, g.p, g.log2m, int(per_channel), stream)
        launches = {"fftconv_mixed": 1}
    else:
        batch = min(scratch_frames(n, 4), c * nf)
        scratch = torch.empty((4, batch * n), dtype=torch.float32, device=x.device)
        f1, f2 = plan.factors
        w1, w2, post, _ = table_ptrs(tw, offs)
        rc = lib.srcdsp_fftconv_4step(*ptrs, w1, w2, post, scratch.data_ptr(), yr.data_ptr(),
                                      yi.data_ptr(), c, length, nf, hop, batch,
                                      line_args(plan.lines[0]), line_args(plan.lines[1]), f1,
                                      f2, int(per_channel), stream)
        launches = {"fftconv_4step": 3 * (-(-(c * nf) // batch))}
    _build.check(rc, counter)
    for k, v in launches.items():
        _build.LAUNCHES[k] += v
    return yr, yi


def kernel_info(fft_size: int) -> tuple[int, int, int]:
    """(registers, local-memory bytes, resident blocks per SM) of the
    register body at `fft_size` (on the card)."""
    out = [ctypes.c_int(0) for _ in range(3)]
    _build.check(_build.load().srcdsp_fftconv_info(regs_plan(fft_size).log2n,
                                                   *map(ctypes.byref, out)), "fftconv_info")
    return tuple(v.value for v in out)


@dataclasses.dataclass(frozen=True)
class FftConvKernel:
    """Fused overlap-save filter + its layout contract."""

    fn: Callable          # x [C, 2, R, n2] -> (yr, yi) [C, R-ov_rows, n2]
    fft_size: int
    hop: int              # output samples per frame
    overlap: int          # history samples callers must prepend (zeros at start)
    num_taps: int
    n1: int
    n2: int
    b_frames: int
    num_channels: int
    device: torch.device

    def block_in(self) -> int:
        """Input sample granularity (N must be a multiple of this)."""
        return self.b_frames * self.hop


def make_fftconv_kernel(taps, fft_size: int = 4096, num_channels: int = 1, n2: int = LANE,
                        b_frames: int = 8, precision=None, karatsuba: bool = False,
                        pipelined: bool | None = None, interpret: bool = False,
                        device=None) -> FftConvKernel:
    """Build the fused filter for a fixed tap set, FFT size and tiling.

    `taps` may be [T] (one filter for every channel) or [C, T] (one per
    channel). The geometry is the JAX kernel's (`fftconv_geometry`), and so
    is the `pipelined=True` ValueError when ov_rows does not divide
    b_frames*hs; `precision`, `karatsuba`, `pipelined` and `interpret`
    change nothing else (the TPU kernel's matrix-unit passes and DMA
    staging). On the CPU any fft_size % n2 == 0 runs (the plain version);
    on the card fft_size must lie in K10's domain (`fft_plan`: <= 2^20 and
    a power of two from 256 to 8192, or n2 % 128 == 0 and n1 % 8 == 0, so
    4096 taps at fft 16384 too), else a ValueError states the rule.
    Launches of the register body count under ``fftconv`` (shared taps) or
    ``fftconv_per_channel``, those of the other bodies under
    ``fftconv_mixed`` or ``fftconv_4step`` (three a batch).
    """
    taps = np.asarray(taps, np.float64)
    per_channel = taps.ndim == 2
    if per_channel and taps.shape[0] != num_channels:
        raise ValueError(f"per-channel taps {taps.shape} != C={num_channels}")
    t = taps.shape[-1]
    n1, ov_rows, hs = fftconv_geometry(t, fft_size, n2)
    overlap, hop = ov_rows * n2, hs * n2
    pipe_ok = (b_frames * hs) % ov_rows == 0 if ov_rows else True
    if pipelined and not pipe_ok:
        raise ValueError(f"pipelined form needs ov_rows ({ov_rows}) | b_frames*hs "
                         f"({b_frames * hs})")
    dev = resolve(device)
    plan = fft_plan(fft_size, n2) if dev.type == "cuda" else None
    h_np = freq_response_planes(taps, fft_size)
    h2 = torch.as_tensor(h_np, device=dev)
    tables = hk = None
    if plan:
        tw, offs = plan.tables()
        tables = (torch.as_tensor(tw, device=dev), offs)
        # the body reads H in its own order (FftPlan.h_order), laid out once here
        hk = torch.as_tensor(np.ascontiguousarray(h_np[..., plan.h_order()]), device=dev)
    fft = make_fft_planes(fft_size, device=dev)
    counter = "fftconv_per_channel" if per_channel else "fftconv"

    def fn(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        c, two, r, nn2 = x.shape
        if two != 2 or nn2 != n2 or c != num_channels:
            raise ValueError(f"x shape {tuple(x.shape)} != [{num_channels}, 2, R, {n2}]")
        rows_out = r - ov_rows
        if rows_out <= 0 or rows_out % (b_frames * hs) != 0:
            raise ValueError(f"output rows {rows_out} not a multiple of {b_frames * hs}")
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"x must be contiguous float32, got {x.dtype}")
        if x.device != dev:
            raise ValueError(f"x on {x.device}, kernel built for {dev}")
        x3 = x.reshape(c, 2, r * n2)
        if cuda_or_cpu(x):
            yr, yi = _fftconv_cuda(x3, hk, tables, plan, hop, per_channel, counter)
        else:
            yr, yi = fftconv_plain(x3, h2, fft, fft_size, hop)
        return yr.reshape(c, rows_out, n2), yi.reshape(c, rows_out, n2)

    return FftConvKernel(fn=fn, fft_size=fft_size, hop=hop, overlap=overlap, num_taps=t,
                         n1=n1, n2=n2, b_frames=b_frames, num_channels=num_channels,
                         device=dev)


def fftconv_pallas(kernel: FftConvKernel, x_planes: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """x_planes: [C, 2, overlap + N] float32 (prepend `kernel.overlap` history
    samples, zeros at stream start), N a multiple of kernel.block_in().
    Returns (yr, yi) [C, N]: the causal FIR output."""
    c = x_planes.shape[0]
    n = x_planes.shape[-1] - kernel.overlap
    yr, yi = kernel.fn(x_planes.reshape(c, 2, -1, kernel.n2))
    return yr.reshape(c, n), yi.reshape(c, n)


class FftConvStream:
    """Streaming driver for K11: carries the overlap prefix, so callers feed
    raw [C, 2, N] chunks (N a multiple of kernel.block_in()) and receive
    filtered planes [C, N]. Chunked output equals one-shot bit for bit (the
    same frames). Each call concatenates hist and the chunk, one copy of the
    chunk; hist is kept as a copy of its own, not a view of that buffer."""

    def __init__(self, kernel: FftConvKernel):
        self.kernel = kernel
        self.hist = torch.zeros((kernel.num_channels, 2, kernel.overlap), dtype=torch.float32,
                                device=kernel.device)

    def process(self, x_chunk: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        xin = torch.cat([self.hist, x_chunk], dim=-1)
        yr, yi = fftconv_pallas(self.kernel, xin)
        self.hist = xin[..., xin.shape[-1] - self.kernel.overlap:].contiguous()
        return yr, yi
