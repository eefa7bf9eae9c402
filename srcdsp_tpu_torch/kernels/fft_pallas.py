"""Batched FFT, kernel K10 (counterpart of ``srcdsp_tpu/kernels/fft_pallas.py``).

(xr, xi) [B, N] float32 planes -> the DFT of each frame. The JAX kernel runs
the four-step factorization N = n1 * n2 (n1 = N / n2) as two DFT matrix
products and emits each frame in the four-step's digit order: frame row k1,
lane k2 holds X[k1 + n1*k2]. There `natural_order=True` adds the [B, n1,
n2] -> [B, n2, n1] transpose that gives index-linear spectra,
`natural_order=False` returns the digit order and `natural_order="kernel"`
has the kernel store in natural order itself.

On the card `fft_plan` picks one of three CUDA bodies for each size:

- a power of two from 256 to 8192: ``csrc/fft.cu`` over ``csrc/fft_regs.cuh``,
  a register-resident radix-16 Stockham FFT (16 samples per thread, two
  shared-memory exchanges between the three passes at N = 4096);
- any other size the JAX kernel takes (n2 % 128 == 0 and n1 % 8 == 0, so a
  multiple of 1024) up to 16384: ``csrc/fft_mixed.cu``, one block a frame,
  N = P M (P odd up to 15, 1 at 16384; MIXED_SHAPES), on the compile-time
  register schedule of ``csrc/fft_lines.cuh``: the odd pass (a P-point DFT
  in registers a butterfly, straight from device memory), then fft_regs.cuh's
  Stockham passes on the P sub-transforms of M points, 16 values a thread;
- such a size from 17408 (FOUR_STEP_MIN) to 2^20: ``csrc/fft_4step.cu``, the
  four-step N = f1 * f2 in two kernels over a scratch buffer in device memory
  (the f1-point column transforms times W_N^{b c}, then the f2-point row
  transforms), each a tile of adjacent lines on the same register schedule
  (FOUR_STEP_LINES: an odd part above 15 that is the product of two up to
  15, as 21 = 3 x 7, is split across the two lines), or, for a line of no
  instantiated shape (a prime above 15, as 17 or 1021, or an odd part that
  no two factors up to 15 make, as 27 in 864), a Bluestein line
  (`BluesteinLine`): a chirp, then the cyclic convolution on two register
  transforms of M = 2^9 ... 2^12 >= 2L - 1 points at P = 1.

The output order is always a store index, so the natural store equals the
digit store followed by the transpose bit for bit, and `natural_order=True`
launches the natural store with no transpose. The kernels' schedules are
mirrored here (`regs_*` for ``fft_regs.cuh``; the private `_odd_trig`,
`_line_shape`, `_line_order`, `_forward_order`, `_reg_line_table`,
`_mixed_shape`, `_mixed_stage` and `_line_at` for the compile-time
schedules of ``fft_lines.cuh`` and its two bodies, `_bluestein_*` for its
Bluestein lines and `_digit_position` for the digit store): the host builds the kernels' tables
from them (`FftPlan.tables`) and the CPU tests run them in numpy. On a CPU
tensor the wrappers run `fft_rows_plain`, the JAX kernel's own
factorization in float32 matrix products with its constants (`fft_consts`),
which takes any n1, n2; on a CUDA tensor they launch a kernel or raise.

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

__all__ = ["BluesteinLine", "FftKernel", "FftPlan", "LineShape", "make_fft_kernel",
           "ifft_pallas", "fft_consts", "fft_rows_plain", "fft_twiddles", "fft_occupancy",
           "fft_plan", "lines_info", "stockham_twiddles", "unscramble", "regs_pad",
           "regs_passes", "regs_shape", "regs_store_index", "regs_twiddle_exponent"]

LANE = 128
MIN_LOG2, MAX_LOG2 = 8, 13      # the register body's sizes: 256 ... 8192 points
MAX_FFT_SIZE = 1 << 20          # the card's cap (the JAX kernel's [2 n1, 2 n1] f32 DFT
                                # matrix alone is 1 GiB there at n2 = 128)
FOUR_STEP_MIN = 17 * 1024       # the four-step from the domain's first size past 16384;
                                # one block a frame below (16384 = 1024 threads x 16 values)
# fft_mixed.cu MIXED_SHAPES: (P, log2 M) of the one-block body, N = P M
MIXED_SHAPES = ((3, 10), (5, 10), (7, 10), (9, 10), (11, 10), (13, 10), (15, 10), (3, 11),
                (5, 11), (7, 11), (3, 12), (1, 14))
# fft_4step.cu FOUR_STEP_LINES: (P, log2 M) of the four-step's register lines
FOUR_STEP_LINES = (tuple((1, m) for m in range(4, 12))
                   + tuple((p, m) for m in (5, 6, 7) for p in range(3, 16, 2)))
# fft_4step.cu BLUESTEIN_LINES: log2 M of the Bluestein lines' transforms
BLUESTEIN_LOG2M = (9, 10, 11, 12)
ODD_FACTORS = (3, 5, 7, 9, 11, 13, 15)  # fft_lines.cuh odd_dft's register butterflies
LINE_TILE = 8192                # points (lanes x length, lanes x M for a Bluestein line) a
                                # four-step block holds at most: 512 threads
MAX_REG_LANES = 64              # lines a four-step block holds at most
SCRATCH_BYTES = 1 << 28         # the four-step's scratch per launch batch (256 MiB)


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


# The compile-time schedules of csrc/fft_lines.cuh (fft_mixed.cu's frames and
# fft_4step.cu's register lines), mirrored item by item. A transform of
# L = P M points (P odd up to 15, M = 2^log2m) runs on P M / 16 threads:
# thread (k_p, t) of sub-transform k_p; the forward's odd pass takes
# butterfly n_m's inputs at rows n_m + M n_p, its P-point DFT (odd_dft),
# output k times W_L^{n_m k} to row n_m + M k; then the sub-transforms over
# rows k_p M ... run fft_regs.cuh's schedule (regs_*); register s of thread
# (k_p, t) then holds X[k_p + P (t + (M/16) s)] (_line_order).

def _odd_trig(p: int) -> np.ndarray:
    """fft_lines.cuh kOddTrig's entries for P: [cos, sin] of 2 pi j / P for
    j = 1 ... (P - 1) / 2, each the float64 value rounded to float32 once."""
    j = np.arange(1, (p - 1) // 2 + 1)
    return np.stack([np.cos(2 * np.pi * j / p), np.sin(2 * np.pi * j / p)], 1).astype(np.float32)


def _odd_trig_offset(p: int) -> int:
    """fft_lines.cuh _odd_trig_offset: P's first float of kOddTrig."""
    return sum(q - 1 for q in range(3, p, 2))


def _line_shape(p: int, log2m: int) -> tuple[int, int, int]:
    """fft_lines.cuh LineShape: (kTM threads of a sub-transform, kTL threads
    of a line, kOdd entries of the odd section)."""
    m = 1 << log2m
    return m // REGS_VALS, p * m // REGS_VALS, (p - 1) * m


def _line_order(p: int, log2m: int, kp, t, s):
    """Where the forward leaves X (fft_lines.cuh line_forward, fft_mixed.cu
    mixed_forward): register s of thread (k_p, t) holds X[k_p + P (t + (M/16) s)]."""
    return kp + p * (t + ((1 << log2m) // REGS_VALS) * s)


def _forward_order(p: int, log2m: int) -> np.ndarray:
    """The forward's order as an array: entry k_p M + k_m holds X[k_p + P k_m]
    (K11's H is laid out so on the host, fftconv_pallas)."""
    m = 1 << log2m
    return (np.arange(p)[:, None] + p * np.arange(m)[None, :]).ravel()


def _reg_line_table(p: int, log2m: int) -> np.ndarray:
    """The table of a transform of P 2^log2m points, flat float32 as the
    kernels read it: the odd section [2, (P - 1) M], W_L^{j k} at (k - 1) M +
    j (k = 1 ... P - 1, j < M), then stockham_twiddles(M) [2, ...], every
    entry made in float64 and rounded once."""
    m = 1 << log2m
    j, k = np.arange(m)[None, :], np.arange(1, p)[:, None]
    odd = _unit_roots((j * k).ravel(), p * m)
    return np.concatenate([odd.ravel(), stockham_twiddles(m).ravel()])


def _mixed_stage(k):
    """fft_mixed.cu _mixed_stage: the natural-order staging's index of X[k]."""
    return k + k // 31


def _mixed_shape(p: int, log2m: int) -> tuple[int, int, int]:
    """fft_mixed.cu MixedShape: (kT threads, kMinBlocks, kPlane floats of one
    plane); the sub-transform k_p's rows at k_p (M + M / 32)."""
    n = p << log2m
    t = n // REGS_VALS
    return t, max(1, 1024 // t), max(regs_pad(n - 1) + 1, _mixed_stage(n - 1) + 1)


def _line_at(j, lane, log2lanes: int):
    """fft_lines.cuh LineTile::at / LineAt: element j of lane `lane` of a
    four-step tile, its shared-memory index."""
    return regs_pad((j << log2lanes) + lane)


@dataclasses.dataclass(frozen=True)
class LineShape:
    """A transform on the compile-time register schedule: `length` = p 2^log2m
    points, `lanes` of them a block (1 for the one-block body)."""

    p: int
    log2m: int
    lanes: int = 1

    @property
    def length(self) -> int:
        return self.p << self.log2m

    @property
    def threads(self) -> int:
        """A block's threads: lanes x P M / 16."""
        return self.lanes * self.length // REGS_VALS

    def smem_bytes(self) -> int:
        """Dynamic shared memory of a block: the two planes."""
        if self.lanes == 1:
            return 2 * _mixed_shape(self.p, self.log2m)[2] * 4
        return 2 * (regs_pad(self.lanes * self.length - 1) + 1) * 4

    def table(self, n: int) -> np.ndarray:
        return _reg_line_table(self.p, self.log2m)

    def descriptor(self) -> tuple[int, ...]:
        """fft_4step.cu make_line's descriptor: (p, log2m, log2 lanes)."""
        return self.p, self.log2m, self.lanes.bit_length() - 1


def _odd_split(n: int) -> tuple[int, int]:
    """(odd part, log2 of the power of two) of n."""
    a = (n & -n).bit_length() - 1
    return n >> a, a


def _reg_line(length: int) -> tuple[int, int] | None:
    """(P, log2 M) of a four-step line on a register schedule, or None."""
    p, a = _odd_split(length)
    return (p, a) if (p, a) in FOUR_STEP_LINES else None


def _reg_line_shape(length: int, lines: int) -> LineShape:
    """A register line of `length` points, `lines` of them in a frame: lanes
    the largest power of two up to MAX_REG_LANES dividing `lines` with lanes x
    length <= LINE_TILE (so at most 512 threads, fft_4step.cu kLineThreads)."""
    return LineShape(*_reg_line(length), _lanes(lines, LINE_TILE // length))


def _unit_roots(e: np.ndarray, n: int) -> np.ndarray:
    """W_N^e as float32 planes [2, len(e)], made in float64."""
    w = np.exp(-2j * np.pi * np.asarray(e, np.float64) / n)
    return np.stack([w.real, w.imag]).astype(np.float32)


def _digit_position(k, n1: int, n2: int):
    """The digit store (every body): X[k] at offset (k mod n1) * n2 + k div n1
    of the frame, row k1 = k mod n1, lane k2 = k div n1 of the [n1, n2] tile."""
    return (k % n1) * n2 + k // n1


# The Bluestein lines of csrc/fft_lines.cuh (bluestein_line): a four-step line
# of L points that no register shape holds is the cyclic convolution of length
# M = 2^log2m >= 2L - 1 that the chirp c[n] = W_{2L}^{n^2 mod 2L} makes of it,
# X[k] = c[k] conj(FFT_M(conj(FFT_M(x c) B)))[k] for k < L, with
# B = FFT_M(b) / M, b[m] = conj(c[m]) for |m| < L wrapped mod M, zero
# elsewhere. Both transforms are the register schedule at P = 1 (fft_regs.cuh,
# `regs_*`), natural order in and out.

def _bluestein_log2m(length: int) -> int:
    """log2 M of a Bluestein line of `length` points: M the least power of two
    >= 2 length - 1."""
    return (2 * length - 2).bit_length()


def _bluestein_chirp(length: int) -> np.ndarray:
    """c[n] = W_{2L}^{n^2 mod 2L}, n < L, as float32 planes [2, L]: the exponent
    in 64-bit integers, the value made in float64 and rounded once."""
    n = np.arange(length, dtype=np.int64)
    return _unit_roots(n * n % (2 * length), 2 * length)


def _bluestein_b(length: int, log2m: int) -> np.ndarray:
    """B = FFT_M(b) / M as float32 planes [2, M] (natural order, the forward's
    order at P = 1): b[m] = conj(c[m]) = W_{2L}^{-(m^2 mod 2L)} for m < L and
    b[M - m] = b[m] for 0 < m < L, made and transformed in float64, rounded
    once."""
    m = 1 << log2m
    n = np.arange(length, dtype=np.int64)
    c = np.exp(2j * np.pi * (n * n % (2 * length)).astype(np.float64) / (2 * length))
    b = np.zeros(m, np.complex128)
    b[:length] = c
    b[m - length + 1:] = c[1:][::-1]
    big = np.fft.fft(b) / m
    return np.stack([big.real, big.imag]).astype(np.float32)


def _bluestein_table(length: int, log2m: int) -> np.ndarray:
    """The table of a Bluestein line, flat float32 as bluestein_line reads it
    (BluesteinShape): stockham_twiddles(M) [2, kStock], B [2, M], c [2, L]."""
    return np.concatenate([stockham_twiddles(1 << log2m).ravel(),
                           _bluestein_b(length, log2m).ravel(),
                           _bluestein_chirp(length).ravel()])


@dataclasses.dataclass(frozen=True)
class BluesteinLine:
    """A four-step line of `length` points that no register shape holds
    (fft_lines.cuh bluestein_line): its two transforms of 2^log2m points on
    the register schedule at P = 1, `lanes` lines a block."""

    length: int
    log2m: int
    lanes: int

    @property
    def threads(self) -> int:
        """A block's threads: lanes x M / 16."""
        return (self.lanes << self.log2m) // REGS_VALS

    def smem_bytes(self) -> int:
        """Dynamic shared memory of a block: the tile's two planes of lanes x M
        floats, padded one in 32."""
        return 2 * (regs_pad((self.lanes << self.log2m) - 1) + 1) * 4

    def table(self, n: int) -> np.ndarray:
        return _bluestein_table(self.length, self.log2m)

    def descriptor(self) -> tuple[int, ...]:
        """fft_4step.cu make_line's descriptor: (0, log2m, log2 lanes)."""
        return 0, self.log2m, self.lanes.bit_length() - 1


def _lanes(lines: int, cap: int) -> int:
    """The largest power of two up to MAX_REG_LANES that divides `lines` and
    is at most `cap` (at least 1)."""
    lanes = 1
    while lanes * 2 <= min(MAX_REG_LANES, cap) and lines % (lanes * 2) == 0:
        lanes *= 2
    return lanes


def _line_geometry(length: int, lines: int) -> LineShape | BluesteinLine:
    """A four-step line of `length` points, `lines` of them in a frame: a
    register line where FOUR_STEP_LINES has its shape, else a Bluestein line
    (lanes as many as divide `lines` with lanes x M <= LINE_TILE: 16 at M =
    512 ... 2 at 4096 where `lines` allows)."""
    if _reg_line(length):
        return _reg_line_shape(length, lines)
    log2m = _bluestein_log2m(length)
    return BluesteinLine(length, log2m, _lanes(lines, LINE_TILE >> log2m))


@dataclasses.dataclass(frozen=True)
class FftPlan:
    """Which CUDA body runs `fft_size` points (`fft_plan`)."""

    fft_size: int
    n1: int                       # the caller's digit tile [n1, n2]
    n2: int
    body: str                     # "regs", "mixed" or "four_step"
    lines: tuple                  # mixed: (the frame's LineShape,); four_step: (f1 columns,
                                  # f2 rows), each a LineShape or a BluesteinLine

    @property
    def log2n(self) -> int:
        return self.fft_size.bit_length() - 1

    @property
    def factors(self) -> tuple[int, int]:
        """(f1, f2) of the four-step: N = f1 * f2."""
        return self.lines[0].length, self.lines[1].length

    def tables(self) -> tuple[np.ndarray, tuple[int, ...]]:
        """(table, section offsets) the body reads. The table is flat float32,
        each section [2, size] (its real plane, then its imaginary one):
        stockham_twiddles for the register body; the frame's _reg_line_table
        for one block a frame; for the four-step the columns' and the rows'
        tables (_reg_line_table, or _bluestein_table for a Bluestein line),
        then W_N^{b c} at b f1 + c and W_N^{c e} at c f2 + e (its two
        post-twiddles, [2, N] each)."""
        n = self.fft_size
        if self.body == "regs":
            return stockham_twiddles(n).ravel(), (0,)
        parts = [g.table(n) for g in self.lines]
        if self.body == "four_step":
            f1, f2 = self.factors
            b, c = np.arange(f2)[:, None], np.arange(f1)[None, :]
            parts += [_unit_roots((b * c).ravel(), n).ravel(),
                      _unit_roots((c.T * b.T).ravel(), n).ravel()]
        offs = tuple(int(x) for x in np.cumsum([0] + [a.size for a in parts[:-1]]))
        return np.ascontiguousarray(np.concatenate(parts)), offs

    def h_order(self) -> np.ndarray:
        """K11's H index for each entry the body reads: the one-block body
        reads H in the forward's order (_forward_order), the others natural."""
        if self.body == "mixed":
            g = self.lines[0]
            return _forward_order(g.p, g.log2m)
        return np.arange(self.fft_size)


def _odd_pair(q: int, a: int) -> tuple[int, int] | None:
    """Two register lines (q1 2^a1, q2 2^a2) for an odd part q = q1 q2 above
    15, both factors up to 15 (a2 = min(7, a - 5), a1 = a - a2, both among
    FOUR_STEP_LINES' 5, 6 and 7), or None (a prime factor above 15, an odd
    part no two such factors make, or a above 14)."""
    a2 = min(7, a - 5)
    for q1 in ODD_FACTORS:
        if q % q1 == 0 and (q1, a - a2) in FOUR_STEP_LINES and (q // q1, a2) in FOUR_STEP_LINES:
            return q1 << (a - a2), (q // q1) << a2
    return None


def _four_step_factors(fft_size: int, n1: int, n2: int) -> tuple[int, int]:
    """(f1, f2): the caller's (n1, n2) when both run a register schedule (so
    the digit store writes whole rows); else, for an odd part q of fft_size
    up to 15, (q x 128, the power of two); else q split across two register
    lines (_odd_pair); else (n1, n2) when both are at most 2048; else the
    divisor pair nearest the square root (f1 >= f2)."""
    q, a = _odd_split(fft_size)
    if _reg_line(n1) and _reg_line(n2):
        return n1, n2
    if 1 < q <= 15:
        return q * 128, 1 << (a - 7)
    pair = _odd_pair(q, a) if q > 15 else None
    if pair:
        return pair
    if q > 15 and n1 <= 2048 and n2 <= 2048:
        return n1, n2
    f2 = max(d for d in range(1, int(fft_size ** 0.5) + 1) if fft_size % d == 0)
    return fft_size // f2, f2


def fft_plan(fft_size: int, n2: int = LANE) -> FftPlan:
    """The CUDA body for `fft_size` points at digit tile n1 = fft_size / n2.

    The card takes every fft_size = n1 * n2 <= 2^20 that is (a) a power of
    two from 256 to 8192 (the register body, ``fft.cu``), or (b) meets the
    JAX kernel's tiling rule n2 % 128 == 0 and n1 % 8 == 0 (so a multiple of
    1024; any n2, 384 included): up to 16384 one block a frame
    (``fft_mixed.cu``, N = P M of MIXED_SHAPES), from FOUR_STEP_MIN (17408)
    the four-step (``fft_4step.cu``). Anything else raises a ValueError that
    states the rule.
    """
    rule = (f"the CUDA FFT kernels take fft_size = n1 * n2 <= {MAX_FFT_SIZE} that is a power "
            f"of two from {1 << MIN_LOG2} to {1 << MAX_LOG2}, or has n2 % 128 == 0 and "
            f"n1 % 8 == 0")
    if n2 <= 0 or fft_size <= 0 or fft_size % n2:
        raise ValueError(f"{rule}; got fft_size {fft_size}, n2 {n2} (fft_size % n2 != 0)")
    n1 = fft_size // n2
    if fft_size > MAX_FFT_SIZE:
        raise ValueError(f"{rule}; got fft_size {fft_size} > {MAX_FFT_SIZE}")
    log2n = fft_size.bit_length() - 1
    if fft_size == 1 << log2n and MIN_LOG2 <= log2n <= MAX_LOG2:
        return FftPlan(fft_size, n1, n2, "regs", ())
    if n2 % LANE or n1 % 8:
        raise ValueError(f"{rule}; got fft_size {fft_size} = {n1} * {n2}")
    if fft_size < FOUR_STEP_MIN:
        q, a = _odd_split(fft_size)
        shape = (q, a) if q > 1 else (1, 14)
        assert shape in MIXED_SHAPES, fft_size
        return FftPlan(fft_size, n1, n2, "mixed", (LineShape(*shape),))
    f1, f2 = _four_step_factors(fft_size, n1, n2)
    return FftPlan(fft_size, n1, n2, "four_step",
                   (_line_geometry(f1, f2), _line_geometry(f2, f1)))


MIXED_KERNELS = ("fft_mixed", "fft_mixed_digit", "fftconv_mixed")  # fft_mixed.cu's info `which`
FOUR_STEP_KERNELS = ("cols", "rows", "mid", "out")  # fft_4step.cu srcdsp_fft_4step_info's `which`


def lines_info(kernel: str, geometry) -> tuple[int, int, int]:
    """(registers, local-memory bytes, resident blocks per SM) on the card of
    a kernel of the two bodies: one of MIXED_KERNELS at a one-block
    LineShape (K10's natural and digit stores, K11), or a four-step step
    (FOUR_STEP_KERNELS: ``cols``, ``rows``, K11's ``mid``, ``out``) on its
    line."""
    out = [ctypes.c_int(0) for _ in range(3)]
    lib = _build.load()
    if kernel in MIXED_KERNELS:
        rc = lib.srcdsp_fft_mixed_info(MIXED_KERNELS.index(kernel), geometry.p, geometry.log2m,
                                       *map(ctypes.byref, out))
    else:
        desc = geometry.descriptor()
        rc = lib.srcdsp_fft_4step_info(FOUR_STEP_KERNELS.index(kernel),
                                       (ctypes.c_int * len(desc))(*desc), geometry.length,
                                       *map(ctypes.byref, out))
    _build.check(rc, "lines_info")
    return tuple(v.value for v in out)


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


def regs_plan(fft_size: int) -> FftPlan:
    """fft_plan for a size the register body takes; any other raises."""
    plan = fft_plan(fft_size, min(fft_size, LANE))
    if plan.body != "regs":
        raise ValueError(f"the register body takes powers of two from {1 << MIN_LOG2} to "
                         f"{1 << MAX_LOG2} points, got {fft_size}")
    return plan


def fft_occupancy(fft_size: int) -> int:
    """Resident blocks per SM of the register body at `fft_size` (on the card)."""
    blocks = ctypes.c_int(0)
    _build.check(_build.load().srcdsp_fft_occupancy(regs_plan(fft_size).log2n,
                                                   ctypes.byref(blocks)), "fft_occupancy")
    return blocks.value


def line_args(g) -> "ctypes.Array":
    """A four-step line's descriptor as a C int array (fft_4step.cu make_line)."""
    desc = g.descriptor()
    return (ctypes.c_int * len(desc))(*desc)


def scratch_frames(fft_size: int, planes: int) -> int:
    """Frames of one four-step batch: `planes` float32 planes of fft_size
    each within SCRATCH_BYTES (at least one, at most 65,535: a grid's y)."""
    return max(1, min(65535, SCRATCH_BYTES // (4 * planes * fft_size)))


def table_ptrs(tw: torch.Tensor, offs: tuple[int, ...]) -> list[int]:
    """Device pointers of the table's sections (FftPlan.tables' offsets)."""
    return [tw.data_ptr() + 4 * o for o in offs]


def _fft_cuda(xr: torch.Tensor, xi: torch.Tensor, tables: tuple, plan: FftPlan, natural: bool,
              counter: str) -> tuple[torch.Tensor, torch.Tensor]:
    lib = _build.load()
    tw, offs = tables
    yr = torch.empty_like(xr)
    yi = torch.empty_like(xi)
    n = plan.fft_size
    b = xr.numel() // n
    stream = _build.stream_handle(xr)
    if plan.body == "regs":
        rc = lib.srcdsp_fft(xr.data_ptr(), xi.data_ptr(), tw.data_ptr(), yr.data_ptr(),
                            yi.data_ptr(), b, plan.log2n, plan.n2.bit_length() - 1, int(natural),
                            stream)
        launches = {counter: 1}
    elif plan.body == "mixed":
        g = plan.lines[0]
        rc = lib.srcdsp_fft_mixed(xr.data_ptr(), xi.data_ptr(), tw.data_ptr(), yr.data_ptr(),
                                  yi.data_ptr(), b, g.p, g.log2m, plan.n1, plan.n2,
                                  int(not natural), stream)
        launches = {"fft_mixed": 1}
    else:
        batch = min(scratch_frames(n, 2), b)
        scratch = torch.empty((2, batch * n), dtype=torch.float32, device=xr.device)
        f1, f2 = plan.factors
        w1, w2, post, _ = table_ptrs(tw, offs)
        rc = lib.srcdsp_fft_4step(xr.data_ptr(), xi.data_ptr(), w1, w2, post,
                                  scratch.data_ptr(), yr.data_ptr(),
                                  yi.data_ptr(), b, batch, line_args(plan.lines[0]),
                                  line_args(plan.lines[1]), f1, f2, plan.n1, plan.n2,
                                  int(not natural), stream)
        launches = {"fft_4step": 2 * (-(-b // batch))}
    _build.check(rc, counter)
    for k, v in launches.items():
        _build.LAUNCHES[k] += v
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
    a multiple of b_frames, as for the JAX kernel. On the CPU any n1, n2
    runs (the plain version). On the card the size must lie in `fft_plan`'s
    domain, the JAX kernel's with interpret=False and a cap: fft_size <=
    2^20 and either a power of two from 256 to 8192 or n2 % 128 == 0 and
    n1 % 8 == 0 (3072, 5120, 11264, 12288, 16384, 65536, 2^20, ...; n2 384
    too); anything else raises. `precision` is accepted and changes nothing:
    the port computes in float32 at both settings, which meets the
    reference's DEFAULT accuracy too. `interpret` has no counterpart.
    natural_order: True (natural order: on the card the kernel's natural
    store, no transpose), False (digit order) or "kernel" (the same natural
    store, the JAX kernel's ``fn_nat``). Launches of the register body
    count under ``fft``, ``fft_digit`` and ``fft_nat`` respectively, those
    of the other bodies under ``fft_mixed`` or ``fft_4step`` (two a batch).
    """
    n1 = fft_size // n2
    if n1 * n2 != fft_size:
        raise ValueError(f"fft_size {fft_size} % n2 {n2} != 0")
    if natural_order not in (True, False, "kernel"):
        raise ValueError(f"natural_order must be True, False or 'kernel', got {natural_order!r}")
    dev = resolve(device)
    plan = fft_plan(fft_size, n2) if dev.type == "cuda" else None
    consts = tuple(torch.as_tensor(a, device=dev) for a in fft_consts(fft_size, n2, b_frames))
    tables = None
    if plan:
        tw, offs = plan.tables()
        tables = (torch.as_tensor(tw, device=dev), offs)
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
            return _fft_cuda(xr, xi, tables, plan, False, rows_counter)
        return fft_rows_plain(xr, xi, consts, n1, n2)

    def fn_nat(consts, xr: torch.Tensor, xi: torch.Tensor, counter: str
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """Natural order stored by the kernel: checked [B, N] planes in and
        out (the kernel takes them as they are, no reshape)."""
        if cuda_or_cpu(xr):
            return _fft_cuda(xr, xi, tables, plan, True, counter)
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
