"""Batched FFT, kernel K10 (counterpart of ``srcdsp_tpu/kernels/fft_pallas.py``).

(xr, xi) [B, N] float32 planes -> the DFT of each frame. The JAX kernel runs
the four-step factorization N = n1 * n2 (n1 = N / n2) as two DFT matrix
products and emits each frame in the four-step's digit order: frame row k1,
lane k2 holds X[k1 + n1*k2]. There `natural_order=True` adds the [B, n1,
n2] -> [B, n2, n1] transpose that gives index-linear spectra,
`natural_order=False` returns the digit order and `natural_order="kernel"`
has the kernel store in natural order itself.

The CUDA kernel (``csrc/fft.cu`` over ``csrc/fft_regs.cuh``) is a
register-resident radix-16 Stockham FFT for powers of two 256 <= N <= 8192:
16 samples per thread, two shared-memory exchanges between the three passes
at N = 4096. The output order is its store index, so the natural store
equals the digit store followed by the transpose bit for bit, and
`natural_order=True` launches the natural store with no transpose. The
kernel's schedule is mirrored here (`regs_passes`, `regs_pad`,
`regs_store_index`, `regs_twiddle_exponent`): the host builds the kernel's
twiddle table from it (`stockham_twiddles`) and the CPU tests run it in
numpy. On a CPU tensor the wrappers run `fft_rows_plain`, the JAX kernel's
own factorization in float32 matrix products with its constants
(`fft_consts`); on a CUDA tensor they launch the kernel or raise.

`ifft_pallas` is the inverse by conj -> forward -> conj and 1/N, around a
natural-order kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable

import numpy as np
import torch

from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.kernels import _build
from srcdsp_tpu_torch.kernels.mixfir import cuda_or_cpu
from srcdsp_tpu_torch.ops.fir import pin_f32

__all__ = ["FftKernel", "make_fft_kernel", "ifft_pallas", "fft_consts", "fft_rows_plain",
           "fft_twiddles", "fft_occupancy", "stockham_twiddles", "unscramble",
           "check_cuda_fft_size", "regs_pad", "regs_passes", "regs_shape", "regs_store_index",
           "regs_twiddle_exponent"]

LANE = 128
MIN_LOG2, MAX_LOG2 = 8, 13      # the CUDA kernels' sizes: 256 ... 8192 points


def _dft(n: int, sign: float) -> np.ndarray:
    k = np.arange(n)
    return np.exp(sign * 2j * np.pi * np.outer(k, k) / n)


def _lhs_comb(m: np.ndarray) -> np.ndarray:
    """[[Mr, -Mi], [Mi, Mr]]: out_stacked_rows = comb @ in_stacked_rows."""
    return np.block([[m.real, -m.imag], [m.imag, m.real]]).astype(np.float32)


def _kpack(m: np.ndarray) -> np.ndarray:
    """[n, 3n] = [Mr | Mi+Mr | Mi-Mr] for the rhs 3-matmul complex form."""
    return np.concatenate([m.real, m.imag + m.real, m.imag - m.real], axis=1).astype(np.float32)


def fft_consts(fft_size: int, n2: int, b_frames: int) -> tuple[np.ndarray, ...]:
    """The JAX kernel's constants (w1c [2n1, 2n1], w2k [n2, 3n2],
    twf_t [2, n1, b_frames*n2]), float32, made as ``fft_pallas.py`` makes them."""
    n1 = fft_size // n2
    w1c = _lhs_comb(_dft(n1, -1.0))
    w2k = _kpack(_dft(n2, -1.0).T)
    twf = np.exp(-2j * np.pi * np.outer(np.arange(n1), np.arange(n2)) / fft_size)
    twf_t = np.stack([np.tile(twf.real, (1, b_frames)),
                      np.tile(twf.imag, (1, b_frames))]).astype(np.float32)
    return w1c, w2k, twf_t


def fft_twiddles(n: int) -> np.ndarray:
    """The CUDA kernels' twiddle table [2, n/2]: e^{-2 pi i j / n}, made in
    float64 and rounded to float32 once."""
    w = np.exp(-2j * np.pi * np.arange(n // 2) / n)
    return np.stack([w.real, w.imag]).astype(np.float32)


# The schedule of csrc/fft_regs.cuh, mirrored item by item (file:line of each).
REGS_VALS = 16  # fft_regs.cuh:37 kFftRegsVals: complex samples a thread keeps in registers


def regs_pad(i):
    """fft_regs.cuh:40 fft_regs_pad: shared-memory index of element i, one
    float of padding after every 32 (ints or integer arrays)."""
    return i + (i >> 5)


def regs_passes(log2n: int) -> list[tuple[int, int]]:
    """(R, NS) of each pass: fft_regs.cuh:43 fft_pass_radix (16, then the
    leftover 2, 4 or 8 last) and :50 fft_pass_span (the product of the
    radices before it)."""
    radices = [16] * (log2n // 4) + ([1 << (log2n % 4)] if log2n % 4 else [])
    spans = np.cumprod([1] + radices[:-1])
    return [(r, int(ns)) for r, ns in zip(radices, spans)]


def regs_shape(log2n: int) -> tuple[int, int, int]:
    """fft_regs.cuh:62 FftRegsShape: (kT threads per frame, kFrames frames
    per block, kPlane floats of one padded plane; the frame's planes lie at
    2 * kPlane * (its index in the block))."""
    t = (1 << log2n) // REGS_VALS
    return t, max(1, 256 // t), regs_pad((1 << log2n) - 1) + 1


def regs_store_index(j, r: int, ns: int, m: int):
    """fft_regs.cuh:231-234 fft_exchange: the element that output m of
    butterfly j of a pass (R, NS) goes to; butterfly j = t + T*g of thread t
    holds registers s = g + (16/R)*m, and the next pass reads element
    t + T*s into register s (fft_regs.cuh:242)."""
    return (j // ns) * ns * r + j % ns + m * ns


def regs_twiddle_exponent(j, r: int, ns: int, m: int, n: int):
    """fft_regs.cuh:208-211 fft_regs_pass: input m of butterfly j is
    multiplied by W_N^e, e this."""
    return m * (j % ns) * (n // (ns * r))


def stockham_twiddles(n: int) -> np.ndarray:
    """The CUDA kernel's twiddle table [2, kTwiddles] (fft_regs.cuh:55
    fft_twiddle_offset): for each pass after the first, entry (m - 1) * NS
    + k holds W_N^e, e = regs_twiddle_exponent(k, R, NS, m, N), the value of
    `fft_twiddles` (made in float64, rounded to float32 once; e >= N/2 is
    -W_N^{e - N/2}), so a warp reads consecutive entries."""
    log2n = n.bit_length() - 1
    tw = fft_twiddles(n)
    full = np.concatenate([tw, -tw], axis=1)
    idx = [regs_twiddle_exponent(np.arange(ns)[None, :], r, ns, np.arange(1, r)[:, None], n)
           .ravel() for r, ns in regs_passes(log2n)[1:]]
    return np.ascontiguousarray(full[:, np.concatenate(idx)])


def check_cuda_fft_size(fft_size: int) -> int:
    """log2(fft_size) for a size the CUDA kernels take (a power of two from
    256 to 8192); anything else raises."""
    log2n = fft_size.bit_length() - 1
    if fft_size != 1 << log2n or not MIN_LOG2 <= log2n <= MAX_LOG2:
        raise ValueError(f"the CUDA FFT kernels take powers of two from {1 << MIN_LOG2} to "
                         f"{1 << MAX_LOG2} points, got {fft_size}")
    return log2n


def fft_rows_plain(xr: torch.Tensor, xi: torch.Tensor, consts, n1: int, n2: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K10: planes [B*n1, n2] -> digit order [B*n1, n2], the JAX
    kernel's math (stage 1 combined complex product over n1, forward twiddle,
    stage 2 in the 3-product form over n2) in float32 matrix products."""
    pin_f32(xr)
    w1c, w2k, twf_t = consts
    b = xr.shape[0] // n1
    x_st = torch.cat([xr.reshape(b, n1, n2), xi.reshape(b, n1, n2)], dim=1)  # [B, 2n1, n2]
    s = torch.matmul(w1c, x_st)
    sr, si = s[:, :n1], s[:, n1:]
    twr, twi = twf_t[0, :, :n2], twf_t[1, :, :n2]
    yr = (sr * twr - si * twi).reshape(b * n1, n2)
    yi = (sr * twi + si * twr).reshape(b * n1, n2)
    t1 = (yr + yi) @ w2k[:, :n2]
    t2 = yi @ w2k[:, n2:2 * n2]
    t3 = yr @ w2k[:, 2 * n2:]
    return t1 - t2, t1 + t3


def unscramble(y: torch.Tensor, n1: int, n2: int) -> torch.Tensor:
    """Digit order [B*n1, n2] -> natural [B, N]: [B, k1, k2] -> [B, k2, k1]."""
    b = y.shape[0] // n1
    return y.reshape(b, n1, n2).transpose(-1, -2).reshape(b, n1 * n2)


def fft_occupancy(fft_size: int) -> int:
    """Resident blocks per SM of the CUDA kernel at `fft_size` (on the card)."""
    blocks = ctypes.c_int(0)
    _build.check(_build.load().srcdsp_fft_occupancy(check_cuda_fft_size(fft_size),
                                                   ctypes.byref(blocks)), "fft_occupancy")
    return blocks.value


def _fft_cuda(xr: torch.Tensor, xi: torch.Tensor, tw: torch.Tensor, log2n: int, n2: int,
              natural: bool, counter: str) -> tuple[torch.Tensor, torch.Tensor]:
    lib = _build.load()
    yr = torch.empty_like(xr)
    yi = torch.empty_like(xi)
    b = xr.numel() >> log2n
    rc = lib.srcdsp_fft(xr.data_ptr(), xi.data_ptr(), tw.data_ptr(), yr.data_ptr(),
                        yi.data_ptr(), b, log2n, n2.bit_length() - 1, int(natural),
                        _build.stream_handle(xr))
    _build.check(rc, counter)
    _build.LAUNCHES[counter] += 1
    return yr, yi


@dataclasses.dataclass(frozen=True)
class FftKernel:
    """Batched FFT + its shape contract (the JAX FftKernel's fields).

    `consts` are the JAX kernel's constants on the kernel's device: the plain
    version computes with them, and `fn_p`/`fn_rows_p` take them as an
    argument as the JAX forms do. The CUDA kernel uses its own twiddle table.
    """

    fn: Callable          # (xr, xi) [B, N] -> (Xr, Xi) [B, N]
    fn_rows: Callable     # pre-shaped planes [B*n1, n2] -> [B*n1, n2] digit order
    fn_p: Callable        # (consts, xr, xi)
    fn_rows_p: Callable   # (consts, xr, xi) pre-shaped
    consts: tuple         # (w1c, w2k, twf_t) tensors
    fft_size: int
    n1: int
    n2: int
    b_frames: int         # B must be a multiple of this
    natural_order: bool | str
    device: torch.device


def make_fft_kernel(fft_size: int = 4096, n2: int = LANE, b_frames: int = 16, precision=None,
                    natural_order: bool | str = True, interpret: bool = False,
                    device=None) -> FftKernel:
    """Build a batched FFT: (xr, xi) [B, N] -> (Xr, Xi) [B, N] float32.

    fft_size % n2 must be 0 (n1 = fft_size // n2 sets the digit order) and B
    a multiple of b_frames, as for the JAX kernel. Its TPU tiling rules (n2 a
    multiple of 128, n1 of 8) shape only the TPU's blocks and are not checked
    here; on the card fft_size must be a power of two from 256 to 8192 (and
    n2 a power of two). `precision` is accepted and changes nothing: the
    port computes in float32 at both settings, which meets the reference's
    DEFAULT accuracy too. `interpret` has no counterpart. natural_order:
    True (natural order: on the card the kernel's natural store, no
    transpose), False (digit order) or "kernel" (the same natural store, the
    JAX kernel's ``fn_nat``). Launches count under ``fft``, ``fft_digit``
    and ``fft_nat`` respectively.
    """
    n1 = fft_size // n2
    if n1 * n2 != fft_size:
        raise ValueError(f"fft_size {fft_size} % n2 {n2} != 0")
    if natural_order not in (True, False, "kernel"):
        raise ValueError(f"natural_order must be True, False or 'kernel', got {natural_order!r}")
    dev = resolve(device)
    if dev.type == "cuda":
        log2n = check_cuda_fft_size(fft_size)
        if n2 & (n2 - 1):
            raise ValueError(f"n2 must be a power of two on the card, got {n2}")
    else:
        log2n = 0
    consts = tuple(torch.as_tensor(a, device=dev) for a in fft_consts(fft_size, n2, b_frames))
    tw = torch.as_tensor(stockham_twiddles(fft_size), device=dev) if log2n else None
    rows_counter = {True: "fft", False: "fft_digit", "kernel": "fft_digit"}[natural_order]

    def check(x: torch.Tensor, shape: tuple) -> None:
        if tuple(x.shape) != shape or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"planes must be contiguous float32 {shape}, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if x.device != dev:
            raise ValueError(f"x on {x.device}, kernel built for {dev}")

    def fn_rows_p(consts, xr: torch.Tensor, xi: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
        """Pre-shaped form: planes [B*n1, n2] in and out, frame f = rows
        [f*n1, (f+1)*n1), sample s of a frame at [s // n2, s % n2]; digit order out."""
        rt, nn2 = xr.shape
        if nn2 != n2 or rt % (b_frames * n1) != 0:
            raise ValueError(f"x [{rt}, {nn2}] needs n2={n2}, rows % {b_frames * n1} == 0")
        check(xr, (rt, n2))
        check(xi, (rt, n2))
        if cuda_or_cpu(xr):
            return _fft_cuda(xr, xi, tw, log2n, n2, False, rows_counter)
        return fft_rows_plain(xr, xi, consts, n1, n2)

    def fn_nat(consts, xr: torch.Tensor, xi: torch.Tensor, counter: str
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """Natural order stored by the kernel: checked [B, N] planes in and
        out (the kernel takes them as they are, no reshape)."""
        if cuda_or_cpu(xr):
            return _fft_cuda(xr, xi, tw, log2n, n2, True, counter)
        yr, yi = fft_rows_plain(xr.reshape(-1, n2), xi.reshape(-1, n2), consts, n1, n2)
        return unscramble(yr, n1, n2), unscramble(yi, n1, n2)

    def fn_p(consts, xr: torch.Tensor, xi: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
        bt, nn = xr.shape
        if nn != fft_size or bt % b_frames != 0:
            raise ValueError(f"x [{bt}, {nn}] needs N={fft_size}, B % {b_frames} == 0")
        check(xr, (bt, nn))
        check(xi, (bt, nn))
        if natural_order:
            return fn_nat(consts, xr, xi, "fft" if natural_order is True else "fft_nat")
        return fn_rows_p(consts, xr.reshape(bt * n1, n2), xi.reshape(bt * n1, n2))

    return FftKernel(fn=lambda xr, xi: fn_p(consts, xr, xi),
                     fn_rows=lambda xr, xi: fn_rows_p(consts, xr, xi),
                     fn_p=fn_p, fn_rows_p=fn_rows_p, consts=consts, fft_size=fft_size,
                     n1=n1, n2=n2, b_frames=b_frames, natural_order=natural_order, device=dev)


def ifft_pallas(kernel: FftKernel, xr: torch.Tensor, xi: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse transform via conj -> forward -> conj and 1/N. `kernel` must
    give natural order for the round-trip identity."""
    yr, yi = kernel.fn(xr, -xi)
    s = np.float32(1.0 / kernel.fft_size)
    return yr * s, -(yi * s)
