"""M-PSK demod in plane form (counterpart of ``srcdsp_tpu/chains/psk_planes.py``):
the tail after the bank kernels K12/K13, plain torch on the card as it is
plain XLA in the reference.

O&M timing from |y|^2, Viterbi&Viterbi carrier phase by repeated complex
squaring + atan2, symbol pick at the timing offset, derotated slicing. The
one-hot reduces of the reference are index selects here: a one-hot sum adds
exact zeros, so both give the same value.

The two tails estimate the carrier from different samples (the bank-stats
tail from every sample of the nearest offset class, `psk_demod_planes` from
the interpolated picks), so their indices may differ by a constant rotation:
compare them after `chains.psk.diff_decode`.
"""

from __future__ import annotations

import numpy as np
import torch

from srcdsp_tpu_torch.chains.fsk_planes import om_timing_planes
from srcdsp_tpu_torch.ops.cpow import cpow
from srcdsp_tpu_torch.ops.nco import TWO_PI
from srcdsp_tpu_torch.types import F32

_HALF = np.float32(0.5)


def _pick(y: torch.Tensor, off: torch.Tensor, sps: int) -> torch.Tensor:
    """y [C, K] -> y[c, s*sps + off[c]] for each symbol s: [C, K/sps]."""
    c, k = y.shape
    idx = off.to(torch.int64)[:, :, None].expand(c, k // sps, 1)
    return torch.gather(y.reshape(c, k // sps, sps), 2, idx)[..., 0]


def pick_symbols_c(yr: torch.Tensor, yi: torch.Tensor, tau: torch.Tensor, sps: int,
                   interp: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Complex symbol pick at offset tau [C, 1].

    interp=True: linear interpolation between samples floor(tau) and
    floor(tau)+1 (the +1 neighbour from a one-sample-left-shifted copy, the
    last sample repeated); interp=False: the nearest offset.
    """
    if not interp:
        off = torch.remainder(torch.round(tau), sps)
        return _pick(yr, off, sps), _pick(yi, off, sps)
    i0 = torch.floor(tau)
    f = tau - i0                              # [C, 1]
    i0 = torch.remainder(i0, sps)
    yr1 = torch.cat([yr[:, 1:], yr[:, -1:]], dim=1)
    yi1 = torch.cat([yi[:, 1:], yi[:, -1:]], dim=1)
    sr = (1.0 - f) * _pick(yr, i0, sps) + f * _pick(yr1, i0, sps)
    si = (1.0 - f) * _pick(yi, i0, sps) + f * _pick(yi1, i0, sps)
    return sr, si


def _slice(sr, si, phi, order: int, offset: float):
    cp, sp = torch.cos(phi), torch.sin(phi)
    dr = sr * cp + si * sp          # s * exp(-j phi)
    di = si * cp - sr * sp
    idx = torch.remainder(torch.round(torch.atan2(di, dr) * np.float32(order / TWO_PI)
                                      - np.float32(offset)), order).to(torch.int32)
    return idx, (dr, di)


def _zero_acc(yr: torch.Tensor):
    z = torch.zeros((yr.shape[0], 1), dtype=F32, device=yr.device)
    return (z, z, z, z)


def psk_demod_bank_stats(yr: torch.Tensor, yi: torch.Tensor, stats: torch.Tensor, sps: int,
                         order: int, offset: float = 0.0, acc=None, interp: bool = True,
                         class_major_b_k: int = 0):
    """Demod tail for the fused bank + stats kernel K13
    (``kernels.bank_pallas.make_bank_psk_kernel``).

    yr/yi: [M, K] bank output planes; stats: [G, M, STATS_LANES] in-kernel
    partial sums (timing tone + per-offset V&V). The timing and carrier
    estimates come from the stats; the K-sized work left is the pick and the
    slice. class_major_b_k: the b_k of a kernel built with class_major=True
    (each b_k block of lanes offset-class-major), else 0.

    acc: (tim_r, tim_i, cr_r, cr_i) carried accumulators or None. Returns
    (acc, (idx int32 [M, K/sps], (soft_r, soft_i))).
    """
    cch = yr.shape[0]
    tim_r, tim_i, cr_r, cr_i = _zero_acc(yr) if acc is None else acc
    s = torch.sum(stats, dim=0)                       # [M, STATS_LANES]
    tim_r = _HALF * tim_r + s[:, 0:1]
    tim_i = _HALF * tim_i + s[:, 1:2]
    tau = torch.remainder(-np.float32(sps / TWO_PI) * torch.atan2(tim_i, tim_r),
                          np.float32(sps))
    # V&V from the nearest offset class's precomputed sums
    o_near = torch.remainder(torch.round(tau), np.float32(sps))     # [M, 1]
    sel = o_near.to(torch.int64)
    vv_r = torch.gather(s[:, 2:2 + sps], 1, sel)
    vv_i = torch.gather(s[:, 2 + sps:2 + 2 * sps], 1, sel)
    co = np.float32(np.cos(-TWO_PI * offset))
    so = np.float32(np.sin(-TWO_PI * offset))
    cr_r = _HALF * cr_r + (vv_r * co - vv_i * so)
    cr_i = _HALF * cr_i + (vv_r * so + vv_i * co)
    phi = torch.atan2(cr_i, cr_r) / order
    if class_major_b_k:
        # each b_k lane block is offset-class-major: class o holds the
        # block's b_k/sps lanes o*(b_k/sps) .. (o+1)*(b_k/sps) - 1
        spb = class_major_b_k // sps
        idx = sel[:, :, None, None].expand(cch, yr.shape[1] // class_major_b_k, 1, spb)
        sr = torch.gather(yr.reshape(cch, -1, sps, spb), 2, idx).reshape(cch, -1)
        si = torch.gather(yi.reshape(cch, -1, sps, spb), 2, idx).reshape(cch, -1)
    else:
        sr, si = pick_symbols_c(yr, yi, tau, sps, interp=interp)
    idx, soft = _slice(sr, si, phi, order, offset)
    return (tim_r, tim_i, cr_r, cr_i), (idx, soft)


def psk_demod_planes(yr: torch.Tensor, yi: torch.Tensor, sps: int, order: int,
                     tone_cos: torch.Tensor, tone_sin: torch.Tensor, offset: float = 0.0,
                     acc=None):
    """Demodulate matched-filtered baseband planes [C, K] -> indices.

    acc: (tim_r, tim_i, cr_r, cr_i) carried accumulators or None. Returns
    (acc, (idx int32 [C, K/sps], (soft_r, soft_i))).
    """
    tim_r, tim_i, cr_r, cr_i = _zero_acc(yr) if acc is None else acc
    power = yr * yr + yi * yi
    tau, tim_r, tim_i = om_timing_planes(power, tone_cos, tone_sin, tim_r, tim_i, sps)
    sr, si = pick_symbols_c(yr, yi, tau, sps)
    # normalise so the M-th power does not overweight amplitude outliers
    scale = torch.sqrt(torch.mean(sr * sr + si * si, dim=-1, keepdim=True) + 1e-12)
    sr = sr / scale
    si = si / scale
    # V&V: angle(sum s^M * e^{-j 2 pi offset}) / M with a carried accumulator
    pr, pi = cpow(sr, si, order)
    co = np.float32(np.cos(-TWO_PI * offset))
    so = np.float32(np.sin(-TWO_PI * offset))
    vr = torch.sum(pr * co - pi * so, dim=-1, keepdim=True)
    vi = torch.sum(pr * so + pi * co, dim=-1, keepdim=True)
    cr_r = _HALF * cr_r + vr
    cr_i = _HALF * cr_i + vi
    phi = torch.atan2(cr_i, cr_r) / order
    idx, soft = _slice(sr, si, phi, order, offset)
    return (tim_r, tim_i, cr_r, cr_i), (idx, soft)
