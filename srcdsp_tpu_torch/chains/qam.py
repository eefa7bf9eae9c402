"""Square-QAM demodulator chain (counterpart of ``srcdsp_tpu/chains/qam.py``).

The front end (NCO mix -> RRC matched filter + decimate -> O&M symbol timing)
is the PSK chain's. Carrier and gain are feedforward:

1. Coarse carrier by the 4th-power estimator: E[s^4] of an axis-aligned
   square QAM is real negative, so phi = angle(-sum s^4)/4 (carried
   accumulator, mod pi/2).
2. Fine carrier and gain: slice, least-squares fit one complex gain
   g = <y, s_hat>/<|s_hat|^2>, divide by it, slice again.
3. Gray slicing as arithmetic: per axis k = clip(round((y/s + (L-1))/2)),
   g = k ^ (k >> 1), index = (g_I << bits_axis) | g_Q.

The pi/2 ambiguity is resolved by the quadrant-differential helpers
(`quad_diff_encode` / `quad_diff_decode`) or a pilot. Constellation: unit
average power, levels (2k - (L-1)) * s per axis, s = sqrt(3 / (2 (M-1))).
The constellation and rotation tables are host numpy.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from srcdsp_tpu_torch.chains.sync import TimingState, timing_estimate, timing_init, timing_sample
from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.ops.cpow import cpow
from srcdsp_tpu_torch.ops.fir import FirState, fir_apply, fir_init
from srcdsp_tpu_torch.ops.nco import NcoState, freq_to_word, nco_apply, nco_init, word_tensor
from srcdsp_tpu_torch.ops.window import root_raised_cosine
from srcdsp_tpu_torch.types import CF32, F32

I32 = torch.int32


def _axis_levels(order: int) -> int:
    l = math.isqrt(order)
    if l * l != order or l < 2 or (l & (l - 1)):
        raise ValueError("order must be a square power of 4 (4, 16, 64, 256)")
    return l


def qam_scale(order: int) -> float:
    """Per-axis lattice half-step s: levels are (2k-(L-1))*s, unit avg power."""
    return math.sqrt(3.0 / (2.0 * (order - 1)))


def _inv_gray(l: int) -> np.ndarray:
    """Binary level index of each Gray label g < l (prefix xor)."""
    inv = np.zeros(l, np.int64)
    for g in range(l):
        b, sh = g, 1
        while sh < l.bit_length():
            b ^= b >> sh
            sh <<= 1
        inv[g] = b
    return inv


def qam_constellation(order: int) -> np.ndarray:
    """[order] complex64 points indexed by Gray symbol index (host numpy)."""
    l = _axis_levels(order)
    bits_ax = l.bit_length() - 1
    s = qam_scale(order)
    inv = _inv_gray(l)
    pts = np.empty(order, np.complex64)
    for idx in range(order):
        ki, kq = inv[idx >> bits_ax], inv[idx & (l - 1)]
        pts[idx] = ((2 * ki - (l - 1)) + 1j * (2 * kq - (l - 1))) * s
    return pts


def _levels(v: torch.Tensor, l: int, s: float) -> torch.Tensor:
    return torch.clamp(torch.round((v / s + (l - 1)) * 0.5), 0, l - 1)


def _gray_index(ki: torch.Tensor, kq: torch.Tensor, bits_ax: int) -> torch.Tensor:
    ki, kq = ki.to(I32), kq.to(I32)
    return ((ki ^ (ki >> 1)) << bits_ax) | (kq ^ (kq >> 1))


def qam_slice(y: torch.Tensor, order: int) -> torch.Tensor:
    """Nearest-point Gray symbol indices (int32) for unit-avg-power symbols."""
    l = _axis_levels(order)
    s = qam_scale(order)
    return _gray_index(_levels(y.real, l, s), _levels(y.imag, l, s), l.bit_length() - 1)


def qam_slice_planes(vr: torch.Tensor, vi: torch.Tensor, order: int
                     ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Plane form of `qam_slice`: float32 (re, im) planes -> (Gray indices
    int32, (shr, shi) nearest-point coordinate planes)."""
    l = _axis_levels(order)
    s = float(np.float32(qam_scale(order)))
    ki = _levels(vr, l, s)
    kq = _levels(vi, l, s)
    shr = (2.0 * ki - (l - 1)) * s
    shi = (2.0 * kq - (l - 1)) * s
    return _gray_index(ki, kq, l.bit_length() - 1), (shr, shi)


def qam_modulate(rng: np.random.Generator, nsym: int, order: int,
                 channel_shape: tuple = (), device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Random Gray symbol indices from a numpy generator (the reference draws
    from jax.random) and their constellation points, on the device."""
    device = resolve(device)
    idx = rng.integers(0, order, (*channel_shape, nsym))
    return (torch.as_tensor(idx.astype(np.int32), device=device),
            torch.as_tensor(qam_constellation(order)[idx], device=device))


def rotation_map(order: int) -> np.ndarray:
    """[order] int32: index of each point after a +90 degree rotation."""
    pts = qam_constellation(order)
    rot = pts * 1j
    return np.asarray([int(np.argmin(np.abs(pts - rot[i]))) for i in range(order)], np.int32)


def _quad_tables(order: int) -> tuple[np.ndarray, np.ndarray]:
    """Per symbol index: (rotation count from its first-quadrant
    representative, that representative's index)."""
    pts = qam_constellation(order)
    rm_np = rotation_map(order)
    quad_of = np.empty(order, np.int64)
    rep_of = np.empty(order, np.int64)
    for r in range(order):
        if not (pts[r].real > 0 and pts[r].imag > 0):
            continue
        j = r
        for q in range(4):
            quad_of[j] = q
            rep_of[j] = r
            j = int(rm_np[j])
    return quad_of, rep_of


def _rot_k(rm: torch.Tensor, rep: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Apply the 90-degree rotation permutation k (0..3) times."""
    r1 = rm[rep]
    r2 = rm[r1]
    r3 = rm[r2]
    stacked = torch.stack([rep, r1, r2, r3], dim=-1)
    return torch.gather(stacked, -1, k[..., None].to(torch.int64))[..., 0]


def _tables(order: int, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    quad_of, rep_of = _quad_tables(order)
    return (torch.as_tensor(quad_of, device=device), torch.as_tensor(rep_of, device=device),
            torch.as_tensor(rotation_map(order), dtype=torch.int64, device=device))


def quad_diff_encode(idx: torch.Tensor, order: int) -> torch.Tensor:
    """Make the stream invariant to pi/2 slips: tx[k] = R^{q[k]}(rep(data[k]))
    with q[k] = cumsum(quad(data)) mod 4."""
    quad, rep, rm = _tables(order, idx.device)
    i = idx.to(torch.int64)
    q = torch.remainder(torch.cumsum(quad[i], dim=-1), 4)
    return _rot_k(rm, rep[i], q).to(I32)


def quad_diff_decode(idx: torch.Tensor, order: int) -> torch.Tensor:
    """Invert `quad_diff_encode` from received indices (slips cancel)."""
    quad, rep, rm = _tables(order, idx.device)
    i = idx.to(torch.int64)
    q = quad[i]
    prev = torch.cat([torch.zeros_like(q[..., :1]), q[..., :-1]], dim=-1)
    return _rot_k(rm, rep[i], torch.remainder(q - prev, 4)).to(I32)


@dataclasses.dataclass(frozen=True)
class QamParams:
    freq_word: torch.Tensor   # int64 u32 NCO word(s)
    taps: torch.Tensor        # [T] float32 RRC matched filter at the input rate
    decim: int
    sps: int
    order: int


class QamState(NamedTuple):
    nco: NcoState
    fir: FirState
    timing: TimingState
    cr_acc: torch.Tensor      # [...] complex64 4th-power accumulator


def make_qam_params(center_freq: float, decim: int, sps: int, order: int = 16,
                    rrc_beta: float = 0.35, rrc_span: int = 8, device=None) -> QamParams:
    device = resolve(device)
    taps = root_raised_cosine(decim * sps, rrc_span, beta=rrc_beta)
    _axis_levels(order)
    return QamParams(freq_word=word_tensor(freq_to_word(-center_freq), device),
                     taps=torch.as_tensor(taps, device=device), decim=decim, sps=sps,
                     order=order)


def qam_init(params: QamParams, channel_shape: tuple = ()) -> QamState:
    dev = params.taps.device
    return QamState(nco=nco_init(channel_shape, device=dev),
                    fir=fir_init(int(params.taps.shape[-1]), channel_shape, device=dev),
                    timing=timing_init(params.sps, channel_shape, dtype=CF32, device=dev),
                    cr_acc=torch.zeros(channel_shape, dtype=CF32, device=dev))


def qam_apply(params: QamParams, state: QamState, x: torch.Tensor
              ) -> tuple[QamState, tuple[torch.Tensor, torch.Tensor]]:
    """Demodulate one block. x: [..., N], N % (decim*sps) == 0.

    Returns (state, (sym_idx [..., Nsym] int32, soft [..., Nsym] complex64)).
    """
    nco_s, mixed = nco_apply(params.freq_word, state.nco, x)
    fir_s, bb = fir_apply(params.taps, state.fir, mixed, decim=params.decim)
    power = (bb.real ** 2 + bb.imag ** 2).to(F32)
    acc, tau = timing_estimate(state.timing.acc, power, params.sps)
    t_last, sym = timing_sample(state.timing.last, bb, tau, params.sps)
    scale = torch.sqrt(torch.mean(torch.abs(sym) ** 2, dim=-1, keepdim=True) + 1e-12)
    symn = (sym / scale).to(CF32)
    c = torch.sum(torch.complex(*cpow(symn.real, symn.imag, 4)), dim=-1)
    acc_new = (np.float32(0.5) * state.cr_acc + c).to(CF32)
    phi = torch.angle(-acc_new) / 4.0
    y0 = (symn * torch.exp(-1j * phi[..., None])).to(CF32)
    pts = torch.as_tensor(qam_constellation(params.order), device=x.device)
    s_hat = pts[qam_slice(y0, params.order).to(torch.int64)]
    num = torch.sum(y0 * torch.conj(s_hat), dim=-1, keepdim=True)
    den = torch.sum(torch.abs(s_hat) ** 2, dim=-1, keepdim=True) + 1e-12
    g = (num / den).to(CF32)
    y = (y0 * torch.conj(g) / (torch.abs(g) ** 2 + 1e-12)).to(CF32)
    new_state = QamState(nco=nco_s, fir=fir_s, timing=TimingState(acc=acc, last=t_last),
                         cr_acc=acc_new)
    return new_state, (qam_slice(y, params.order), y)


def qam_demod_stream(params: QamParams, x: torch.Tensor, block: int,
                     channel_shape: tuple = ()) -> tuple[torch.Tensor, torch.Tensor]:
    """Whole capture: `qam_apply` over blocks of `block` samples."""
    s = x.shape[-1]
    if s % block != 0:
        raise ValueError(f"capture length {s} not divisible by block {block}")
    st = qam_init(params, channel_shape)
    idx, soft = [], []
    for b0 in range(0, s, block):
        st, (i, sf) = qam_apply(params, st, x[..., b0:b0 + block])
        idx.append(i)
        soft.append(sf)
    return torch.cat(idx, dim=-1), torch.cat(soft, dim=-1)
