"""Polyphase analysis bank, kernel K12, and the bank with the PSK statistics,
kernel K13 (counterpart of ``srcdsp_tpu/kernels/bank_pallas.py``).

Layout contract, the reference's:

- input: phase-major planes x [2, M, hist_cols + K] (`phase_major` of flat
  history-prepended planes: column j holds frame j - hist_cols, row c phase
  c; zeros at stream start), K a multiple of b_k;
- hist_cols is P - 1 rounded up to 128 (P + 1 = rows of
  ``ops.channelize_planes.make_channelizer_mats``): callers prepend exactly
  hist_cols columns, so the same numpy input feeds both packages;
- output: channel-major Y [2M, K] = [Yr; Yi];
- K13 also returns stats [K/b_k, M, STATS_LANES]: per b_k block and channel,
  col 0 = sum |y|^2 cos(2 pi koff/sps), col 1 = sum |y|^2 (-sin), cols
  2..2+sps = Re sum y^order per offset class koff, cols 2+sps..2+2sps = Im,
  the rest zeros (koff = frame index mod sps);
- class_major=True stores lane k of each b_k block at
  (k % sps) * (b_k/sps) + k // sps.

The CUDA kernels are ``csrc/bank.cu`` (the fold, then an M-point Stockham
FFT for a power of two M or a direct DFT for any other, not the TPU's dense
matmul; any M whose one-frame tile fits a block's shared memory);
`fft_plan`, `fft_pass_map`, `fft_twiddles`, `fft_frames`, `bank_rows` and
`bank_tile` mirror its FFT schedule, twiddle table, buffer rows and tile. On a CPU tensor the
wrappers run the plain versions beside them: SS^T staged as the reference's ``_stage_ss`` does, times E_comb^T by
``torch.matmul`` (TF32 off), the stats epilogue in torch, the class-major
order as an index permutation (the reference permutes with a one-pass
matmul, exact only where that pass is). On a CUDA tensor they launch the
kernel or raise. Launches count under ``bank`` and ``bank_psk``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.kernels import _build
from srcdsp_tpu_torch.kernels.mixfir import LANE, _round_up, cuda_or_cpu
from srcdsp_tpu_torch.ops.channelize_planes import combined_matrix, make_channelizer_mats
from srcdsp_tpu_torch.ops.cpow import cpow
from srcdsp_tpu_torch.ops.fir import pin_f32
from srcdsp_tpu_torch.ops.nco import TWO_PI

__all__ = ["STATS_LANES", "bank_os2_pallas", "bank_plain", "bank_stats_plain",
           "class_major_index", "make_bank_kernel", "make_bank_psk_kernel", "phase_major",
           "kernel_info"]

STATS_LANES = 128  # stats output lane padding (2 + 2*sps columns used)


def phase_major(x: torch.Tensor, m: int, hist: int) -> torch.Tensor:
    """[2, hist + N] planes -> [2, M, (hist + N)/M] phase-major (contiguous)."""
    total = x.shape[-1]
    return x.reshape(2, total // m, m).transpose(-1, -2).contiguous()


def bank_plain(x: torch.Tensor, e_comb_t: torch.Tensor, m: int, p1: int, hist_cols: int
               ) -> torch.Tensor:
    """Plain K12: SS^T[(plane, r, c), k] = x[plane, c, hist_cols - r + k]
    stacked [2(P+1)M, K], then Y = E_comb^T @ SS^T -> [2M, K]."""
    pin_f32(x)
    k = x.shape[-1] - hist_cols
    ss = torch.cat([x[plane, :, hist_cols - r:hist_cols - r + k]
                    for plane in range(2) for r in range(p1)], dim=0)
    return e_comb_t @ ss


def class_major_index(b_k: int, sps: int, device) -> torch.Tensor:
    """src[n]: the standard lane stored at class-major lane n of a b_k block."""
    n = np.arange(b_k)
    spb = b_k // sps
    return torch.as_tensor((n % spb) * sps + n // spb, device=device)


def bank_stats_plain(y: torch.Tensor, m: int, b_k: int, sps: int, order: int) -> torch.Tensor:
    """Plain K13 epilogue: stats [K/b_k, M, STATS_LANES] of Y [2M, K] in the
    standard lane order (the reference's ``_psk_epilogue``, every block at once)."""
    k = y.shape[-1]
    g = k // b_k
    yr, yi = y[:m].reshape(m, g, b_k), y[m:].reshape(m, g, b_k)
    power = yr * yr + yi * yi
    col = torch.arange(b_k, device=y.device)
    koff = torch.remainder(torch.arange(g, device=y.device)[:, None] * b_k + col, sps)
    ang = koff.to(torch.float32) * np.float32(TWO_PI / sps)
    st = torch.zeros((g, m, STATS_LANES), dtype=torch.float32, device=y.device)
    st[:, :, 0] = torch.sum(power * torch.cos(ang), dim=-1).T
    st[:, :, 1] = torch.sum(power * (-torch.sin(ang)), dim=-1).T
    pr, pi = cpow(yr, yi, order)
    for off in range(sps):
        mask = (koff == off).to(torch.float32)
        st[:, :, 2 + off] = torch.sum(pr * mask, dim=-1).T
        st[:, :, 2 + sps + off] = torch.sum(pi * mask, dim=-1).T
    return st


# The CUDA body's FFT schedule, twiddle table and tile (csrc/bank.cu),
# mirrored item by item.
MAX_TILE = 64            # bank.cu kMaxTile
BANK_BUDGET = 96 * 1024  # bank.cu kBankBudget
MAX_SMEM = 227 * 1024    # bank.cu kMaxSmem


def fft_twiddles(m: int) -> np.ndarray:
    """The table [2, M] the kernels take, tw[q] = e^{+2 pi i q / M}: made in
    float64 and rounded to float32 once."""
    w = np.exp(2j * np.pi * np.arange(m) / m)
    return np.stack([w.real, w.imag]).astype(np.float32)


def fft_plan(m: int, radix: int = 8) -> list[int] | None:
    """bank.cu bank_geometry (npass, radix): the radices of the Stockham
    passes for a power of two M, `radix` (kRadix) while it divides what is
    left, then 4 or 2; None for any other M (a direct DFT)."""
    if m & (m - 1):
        return None
    plan = []
    while m > 1:
        plan.append(radix if m % radix == 0 else 4 if m >= 4 else 2)
        m //= plan[-1]
    return plan


def fft_pass_map(m: int, ns: int, r: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """bank.cu fft_pass: for the M/R units j of a frame after passes of ns
    points in all, (src [M/R, R], dst [M/R, R], tw [M/R, R]): unit j reads
    X[src[j, q]], multiplies by twiddle table entry tw[j, q], runs the
    R-point DFT and writes output q to Y[dst[j, q]]."""
    j = np.arange(m // r)[:, None]
    q = np.arange(r)[None, :]
    k = j & (ns - 1)
    return j + q * (m // r), (j - k) * r + k + q * ns, q * k * (m // (ns * r))


def fft_frames(v: np.ndarray, tw: np.ndarray | None = None, radix: int = 8) -> np.ndarray:
    """The kernel's DFT of frames v [..., M] (complex) through the mirrored
    schedule, in float64 with the float32 table (`fft_twiddles`, or `tw`):
    Y[m] = sum_p v[p] e^{+2 pi i m p / M}, the pass maps of `fft_pass_map`
    for a power of two M, the direct sum (index m*p mod M) for any other."""
    m = v.shape[-1]
    tw = fft_twiddles(m) if tw is None else tw
    w = tw[0].astype(np.float64) + 1j * tw[1].astype(np.float64)
    plan = fft_plan(m, radix)
    x = np.asarray(v, np.complex128)
    if plan is None:
        return x @ w[(np.arange(m)[:, None] * np.arange(m)[None, :]) % m]
    ns = 1
    for r in plan:
        src, dst, ti = fft_pass_map(m, ns, r)
        a = x[..., src] * w[ti]                                      # [..., M/R, R]
        b = a @ np.exp(2j * np.pi * np.outer(np.arange(r), np.arange(r)) / r)
        y = np.empty_like(x)
        y[..., dst] = b
        x, ns = y, ns * r
    return x


def bank_rows(f, tile: int, b_k: int, sps: int, class_major: bool):
    """bank.cu RowMap: the buffer row of tile frame f (an int or an array).
    In class-major runs (b_k % tile == 0, tile % sps == 0) frame f = jj*sps
    + o sits in row o*(tile/sps) + jj, its class-major position; else row f."""
    if not (class_major and b_k % tile == 0 and tile % sps == 0):
        return f
    return (f % sps) * (tile // sps) + f // sps


def bank_tile(m: int, p: int, b_k: int, sps: int, stats: bool) -> tuple[int, int]:
    """bank.cu bank_geometry and bank_tile: (frames a tile F, shared-memory
    bytes of a block); F = 0 where no tile fits a block."""
    def floats(f: int) -> int:
        r4 = lambda v: (v + 3) & ~3  # noqa: E731
        vs = m + 1
        head = r4(p * m) + r4(2 * m) + (r4(2 * sps) + r4(3 * m * sps) if stats else 0)
        return head + r4(2 * f * vs) + r4(max(2 * m * (f + p), 2 * f * vs))

    f = MAX_TILE
    while f > 1 and f // 2 >= b_k:
        f //= 2
    fit = (0, 0)
    while f >= 1:
        nbytes = 4 * floats(f)
        if nbytes <= BANK_BUDGET:
            return f, nbytes
        if nbytes <= MAX_SMEM and fit[0] == 0:
            fit = (f, nbytes)
        f //= 2
    return fit


def kernel_info(m: int, p: int, b_k: int, sps: int = 1, stats: bool = False
                ) -> tuple[int, int, int, int]:
    """(frames a tile, registers, local-memory bytes, resident blocks per
    SM) of K12 (or, with stats, K13) at M channels and P taps a phase (on
    the card)."""
    out = [ctypes.c_int(0) for _ in range(4)]
    _build.check(_build.load().srcdsp_bank_info(m, p, b_k, sps, int(stats),
                                                *map(ctypes.byref, out)), "bank_info")
    return tuple(v.value for v in out)


def _bank_cuda(x: torch.Tensor, h: torch.Tensor, tw: torch.Tensor, m: int, p: int,
               hist_cols: int, b_k: int, stats: bool, sps: int, order: int,
               class_major: bool) -> tuple[torch.Tensor, torch.Tensor | None]:
    lib = _build.load()
    k = x.shape[-1] - hist_cols
    y = torch.empty((2 * m, k), dtype=torch.float32, device=x.device)
    st = (torch.empty((k // b_k, m, STATS_LANES), dtype=torch.float32, device=x.device)
          if stats else None)
    counter = "bank_psk" if stats else "bank"
    rc = lib.srcdsp_bank(x.data_ptr(), h.data_ptr(), tw.data_ptr(), y.data_ptr(),
                         st.data_ptr() if stats else None, m, p, x.shape[-1], hist_cols, k,
                         b_k, sps, order, float(np.float32(TWO_PI / sps)), int(class_major),
                         int(stats), _build.stream_handle(x))
    _build.check(rc, counter)
    _build.LAUNCHES[counter] += 1
    return y, st


class _Bank:
    """What both factories share: the baked matrices, the CUDA operands and
    the input checks."""

    def __init__(self, taps, m: int, b_k: int, pipelined, device):
        er_np, ei_np = make_channelizer_mats(taps, m)
        self.m, self.b_k = m, b_k
        self.p1 = er_np.shape[0]
        # lane-dim DMA slices on the TPU must be 128-aligned: P - 1 rounded up
        # to whole lanes of history columns (the extra columns are zeros)
        self.hist_cols = _round_up(self.p1 - 1, LANE)
        pipe_ok = b_k % self.hist_cols == 0
        if pipelined and not pipe_ok:
            raise ValueError(f"pipelined form needs hist_cols ({self.hist_cols}) | b_k ({b_k})")
        self.dev = resolve(device)
        self.e_comb_t = torch.as_tensor(combined_matrix(er_np, ei_np).T.copy(), device=self.dev)
        h = np.asarray(taps, np.float32)
        self.h = torch.as_tensor(np.pad(h, (0, (-h.shape[0]) % m)), device=self.dev)
        self.tw = torch.as_tensor(fft_twiddles(m), device=self.dev)

    def frames(self, x: torch.Tensor) -> int:
        if x.ndim != 3 or x.shape[0] != 2 or x.shape[1] != self.m:
            raise ValueError(f"x shape {tuple(x.shape)} != [2, {self.m}, hist_cols + K]")
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"x must be contiguous float32, got {x.dtype}")
        if x.device != self.dev:
            raise ValueError(f"x on {x.device}, kernel built for {self.dev}")
        k = x.shape[-1] - self.hist_cols
        if k <= 0 or k % self.b_k != 0:
            raise ValueError(f"K={k} not a multiple of b_k={self.b_k}")
        return k


def make_bank_kernel(taps, num_channels: int, b_k: int = 256, precision=None,
                     pipelined: bool | None = None, device=None):
    """Build K12. Returns (fn, hist_cols):

    fn: x [2, M, hist_cols + K] phase-major planes -> Y [2M, K] = [Yr; Yi]
    channel-major; K % b_k == 0. Callers prepend exactly hist_cols history
    columns (`phase_major` builds the input from flat padded planes).
    `pipelined=True` raises unless hist_cols | b_k, as in the reference, and
    changes nothing else. `precision` is accepted for signature parity and
    ignored: both tiers compute in float32 for every value (the reference's
    DEFAULT is a bf16 pass on a TPU).
    """
    bk = _Bank(taps, num_channels, b_k, pipelined, device)

    def fn(x: torch.Tensor) -> torch.Tensor:
        bk.frames(x)
        if cuda_or_cpu(x):
            return _bank_cuda(x, bk.h, bk.tw, bk.m, bk.p1 - 1, bk.hist_cols, b_k, False, 1, 2,
                              False)[0]
        return bank_plain(x, bk.e_comb_t, bk.m, bk.p1, bk.hist_cols)

    return fn, bk.hist_cols


def bank_os2_pallas(fn, hist_cols: int, x_flat: torch.Tensor, num_channels: int
                    ) -> torch.Tensor:
    """2x-oversampled analysis from two K12 calls and an interleave.

    The even frames are the standard bank; the odd frames are the bank on the
    stream advanced by M/2 samples, with odd channels negated (the
    (-1)^{ch*k} twiddle at odd k). x_flat: [2, (hist_cols + K) * M] flat
    planes (hist_cols*M history samples), K % b_k == 0. Returns Y [2M, 2K]
    channel-major at twice the rate, matching
    ``chains.channelizer.channelize_os2_apply``. The last odd frame reads M/2
    samples past the payload as zeros.
    """
    m = num_channels
    hop = m // 2
    k = x_flat.shape[-1] // m - hist_cols
    y_even = fn(phase_major(x_flat, m, hist_cols))               # [2M, K]
    x_shift = torch.cat([x_flat[:, hop:], x_flat.new_zeros((2, hop))], dim=-1)
    y_odd = fn(phase_major(x_shift, m, hist_cols))
    sign = torch.where(torch.arange(m, device=x_flat.device) % 2 == 1, -1.0, 1.0)
    sign2 = torch.cat([sign, sign]).to(torch.float32)[:, None]    # [2M, 1]
    return torch.stack([y_even, y_odd * sign2], dim=-1).reshape(2 * m, 2 * k)


def make_bank_psk_kernel(taps, num_channels: int, sps: int, order: int = 4, b_k: int = 256,
                         precision=None, class_major: bool = False,
                         pipelined: bool | None = None, device=None):
    """Build K13: K12 plus the PSK epilogue stats. Returns (fn, hist_cols):

    fn: x [2, M, hist_cols + K] phase-major -> (Y [2M, K], stats
    [K/b_k, M, STATS_LANES]); feed the pair to
    ``chains.psk_planes.psk_demod_bank_stats``. b_k must be a multiple of sps
    and order a power of two (V&V by repeated squaring). class_major=True
    stores each b_k block's lanes offset-class-major (pass b_k to the tail as
    class_major_b_k). Y equals K12's bit for bit in the standard order.
    `precision` and `pipelined` act as on `make_bank_kernel`.
    """
    if order & (order - 1) or order < 2:
        raise ValueError(f"order must be a power of two >= 2, got {order}")
    if b_k % sps != 0:
        raise ValueError(f"b_k {b_k} % sps {sps} != 0")
    bk = _Bank(taps, num_channels, b_k, pipelined, device)
    if 2 + 2 * sps > STATS_LANES:
        raise ValueError(f"sps {sps}: 2 + 2*sps stats columns exceed {STATS_LANES}")
    perm = class_major_index(b_k, sps, bk.dev)

    def fn(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        k = bk.frames(x)
        if cuda_or_cpu(x):
            return _bank_cuda(x, bk.h, bk.tw, bk.m, bk.p1 - 1, bk.hist_cols, b_k, True, sps,
                              order, class_major)
        y = bank_plain(x, bk.e_comb_t, bk.m, bk.p1, bk.hist_cols)
        st = bank_stats_plain(y, bk.m, b_k, sps, order)
        if class_major:
            y = y.reshape(2 * bk.m, k // b_k, b_k)[..., perm].reshape(2 * bk.m, k)
        return y, st

    return fn, bk.hist_cols
