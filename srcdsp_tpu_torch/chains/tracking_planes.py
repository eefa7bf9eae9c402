"""Plane forms of the closed-loop tracking chains (counterpart of
``srcdsp_tpu/chains/tracking_planes.py``).

The twins of ``chains.sync_loop`` and ``chains.tracking`` on (re, im) float32
planes, on the loop cores of ``chains.sync_loop``: ``atan2`` for angles,
repeated complex squaring for the M-power detector (``ops.cpow``), a Python
loop of batched steps with one ``gather`` per step for the interpolations.
Same loop math, gains, state semantics and carried-tail seam convention as
the complex forms; the FSK trackers run the loop on the real plane alone
(the discriminator's imag plane is zero).

Front end: the plain ``ops.planes.fused_mix_fir_decim_planes``, one channel
at a time (the reference vmaps it), with the u32 NCO words held in int64
masked to 32 bits.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from srcdsp_tpu_torch.chains.fsk import FskParams
from srcdsp_tpu_torch.chains.fsk_planes import discriminate_planes
from srcdsp_tpu_torch.chains.psk import PskParams, constellation_offset
from srcdsp_tpu_torch.chains.sync_loop import (CostasState, GardnerState, costas_init,
                                               costas_planes, gardner_free_planes, gardner_init,
                                               gardner_planes, plane_rotation)
from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.ops.nco import MASK32, TWO_PI, word_tensor
from srcdsp_tpu_torch.ops.planes import (fused_mix_fir_decim_planes, plane_hist_len,
                                         plane_hist_shifts)
from srcdsp_tpu_torch.types import F32


def gardner_scan_planes(state: GardnerState, xr: torch.Tensor, xi: torch.Tensor, sps: int,
                        kp: float = 0.5, ki: float = 0.02
                        ) -> tuple[GardnerState, tuple[torch.Tensor, torch.Tensor]]:
    """Plane twin of sync_loop.gardner_scan. xr/xi: [..., N], N % sps == 0.
    Returns (state, (sr, si) [..., N/sps - 1])."""
    tau, freq, y = gardner_planes(state.tau, state.freq, torch.stack([xr, xi], dim=-2), sps,
                                  kp, ki)
    return GardnerState(tau=tau, freq=freq), (y[..., 0, :], y[..., 1, :])


def costas_scan_planes(state: CostasState, sr: torch.Tensor, si: torch.Tensor, order: int,
                       kp: float = 0.1, ki: float = 0.01, offset: float = 0.0,
                       valid: torch.Tensor | None = None
                       ) -> tuple[CostasState, tuple[torch.Tensor, torch.Tensor]]:
    """Plane twin of sync_loop.costas_scan (M-power detector by repeated
    complex squaring, then atan2). sr/si: [..., K] symbol-rate planes."""
    return costas_planes(state, sr, si, order, kp, ki, plane_rotation(offset), valid)


class GardnerFreePlanesState(NamedTuple):
    """Plane twin of sync_loop.GardnerFreeState (prev as planes)."""

    pos: torch.Tensor
    freq: torch.Tensor
    prev_r: torch.Tensor
    prev_i: torch.Tensor


def gardner_free_init_planes(channel_shape: tuple = (), tau0: float = 0.0,
                             device=None) -> GardnerFreePlanesState:
    device = resolve(device)
    z = torch.zeros(channel_shape, dtype=F32, device=device)
    return GardnerFreePlanesState(pos=torch.full(channel_shape, tau0, dtype=F32, device=device),
                                  freq=z, prev_r=z, prev_i=z)


def gardner_free_scan_planes(state: GardnerFreePlanesState, xr: torch.Tensor, xi: torch.Tensor,
                             sps: int, kp: float = 0.5, ki: float = 0.02, max_dev: float = 0.05
                             ) -> tuple[GardnerFreePlanesState,
                                        tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Plane twin of sync_loop.gardner_free_scan (skip/stuff timing with a
    static output capacity + validity mask). xr/xi: [..., sps + N] (the
    caller prepends its carried sps tail). Returns (state, (sr, si, valid))."""
    prev = torch.stack([state.prev_r, state.prev_i], dim=-1)
    (pos, freq, prev), (y, valid) = gardner_free_planes(
        state.pos, state.freq, prev, torch.stack([xr, xi], dim=-2), sps, kp, ki, max_dev)
    return (GardnerFreePlanesState(pos=pos, freq=freq, prev_r=prev[..., 0], prev_i=prev[..., 1]),
            (y[..., 0, :], y[..., 1, :], valid))


def psk_slice_planes(yr: torch.Tensor, yi: torch.Tensor, order: int,
                     offset: float = 0.0) -> torch.Tensor:
    """Nearest-constellation index on planes (chains.psk.psk_slice twin:
    index = round(angle/2pi*M - offset) mod M), int32."""
    ang = torch.atan2(yi, yr) * np.float32(order / TWO_PI)
    return torch.remainder(torch.round(ang - np.float32(offset)).to(torch.int32), order)


def _hist_len(params) -> int:
    return plane_hist_len(int(params.taps.shape[-1]), params.decim)


def _coef_matrix(taps: torch.Tensor, decim: int) -> torch.Tensor:
    """``ops.planes.phase_coef_matrix`` built on the taps' device (no copy
    to or from the host): coef[p, s] = h[s*M - p], 0 outside the taps."""
    t = taps.shape[-1]
    a = (torch.arange(plane_hist_shifts(t, decim), device=taps.device)[None, :] * decim
         - torch.arange(decim, device=taps.device)[:, None])
    return torch.where((a >= 0) & (a < t), taps[a.clamp(0, t - 1)], 0.0).to(F32)


def _front_planes(params, word: torch.Tensor, hist: torch.Tensor, x_planes: torch.Tensor):
    """Mix + FIR + decimate the raw planes [C, 2, N] after the carried
    history, one channel at a time. Returns (br, bi [C, N/decim], hist',
    word')."""
    coef = _coef_matrix(params.taps, params.decim)
    cch = x_planes.shape[0]
    xin = torch.cat([hist, x_planes], dim=-1)
    h = hist.shape[-1]
    dword = word_tensor(params.freq_word, x_planes.device).reshape(-1, 1).expand(cch, 1)
    # the history prefix starts h samples before the carried block-start word
    w0 = (word - h * dword) & MASK32
    outs = [fused_mix_fir_decim_planes(coef, w0[c, 0], dword[c, 0], xin[c:c + 1, 0],
                                       xin[c:c + 1, 1], params.decim) for c in range(cch)]
    br = torch.cat([o[0] for o in outs], dim=0)
    bi = torch.cat([o[1] for o in outs], dim=0)
    n = x_planes.shape[-1]
    return br, bi, xin[..., xin.shape[-1] - h:], (word + n * dword) & MASK32


def _fsk_disc_planes(params: FskParams, br, bi, disc_r, disc_i, tail):
    d, pr, pi = discriminate_planes(br, bi, disc_r, disc_i)
    d = d * np.float32(1.0 / params.dev)
    return pr, pi, torch.cat([tail, d], dim=-1)


class PskTrackPlanesState(NamedTuple):
    word: torch.Tensor      # [C, 1] int64 u32 NCO phase word at the block start
    hist: torch.Tensor      # [C, 2, H] carried raw-input planes
    tail_r: torch.Tensor    # [C, sps] carried post-filter planes
    tail_i: torch.Tensor
    gardner: GardnerState
    costas: CostasState


def psk_track_planes_init(params: PskParams, num_channels: int,
                          tau0: float = 0.0) -> PskTrackPlanesState:
    dev = params.taps.device
    return PskTrackPlanesState(
        word=torch.zeros((num_channels, 1), dtype=torch.int64, device=dev),
        hist=torch.zeros((num_channels, 2, _hist_len(params)), dtype=F32, device=dev),
        tail_r=torch.zeros((num_channels, params.sps), dtype=F32, device=dev),
        tail_i=torch.zeros((num_channels, params.sps), dtype=F32, device=dev),
        gardner=gardner_init((num_channels,), tau0=tau0, device=dev),
        costas=costas_init((num_channels,), device=dev))


def psk_track_planes_apply(params: PskParams, state: PskTrackPlanesState,
                           x_planes: torch.Tensor, kp: float = 0.2, ki: float = 0.02
                           ) -> tuple[PskTrackPlanesState,
                                      tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Plane twin of tracking.psk_track_apply. x_planes: [C, 2, N] raw input
    planes, N % (decim*sps) == 0. Returns (state, (idx, soft_r, soft_i))
    with exactly N/(decim*sps) symbols per block."""
    off = constellation_offset(params.order)
    br, bi, hist, word = _front_planes(params, state.word, state.hist, x_planes)
    xr = torch.cat([state.tail_r, br], dim=-1)
    xi = torch.cat([state.tail_i, bi], dim=-1)
    g_s, (sr, si) = gardner_scan_planes(state.gardner, xr, xi, params.sps, kp=kp, ki=ki)
    c_s, (yr, yi) = costas_scan_planes(state.costas, sr, si, params.order, offset=off)
    idx = psk_slice_planes(yr, yi, params.order, off)
    return PskTrackPlanesState(word=word, hist=hist, tail_r=xr[..., xr.shape[-1] - params.sps:],
                               tail_i=xi[..., xi.shape[-1] - params.sps:], gardner=g_s,
                               costas=c_s), (idx, yr, yi)


class FskTrackPlanesState(NamedTuple):
    word: torch.Tensor      # [C, 1] int64 u32 NCO phase word at the block start
    hist: torch.Tensor      # [C, 2, H] carried raw-input planes
    disc_r: torch.Tensor    # [C, 1] previous baseband sample
    disc_i: torch.Tensor
    tail: torch.Tensor      # [C, sps] carried discriminator samples
    gardner: GardnerState


def fsk_track_planes_init(params: FskParams, num_channels: int,
                          tau0: float = 0.0) -> FskTrackPlanesState:
    dev = params.taps.device
    z1 = torch.zeros((num_channels, 1), dtype=F32, device=dev)
    return FskTrackPlanesState(
        word=torch.zeros((num_channels, 1), dtype=torch.int64, device=dev),
        hist=torch.zeros((num_channels, 2, _hist_len(params)), dtype=F32, device=dev),
        disc_r=z1, disc_i=z1,
        tail=torch.zeros((num_channels, params.sps), dtype=F32, device=dev),
        gardner=gardner_init((num_channels,), tau0=tau0, device=dev))


def fsk_track_planes_apply(params: FskParams, state: FskTrackPlanesState,
                           x_planes: torch.Tensor, kp: float = 0.05, ki: float = 0.002
                           ) -> tuple[FskTrackPlanesState, tuple[torch.Tensor, torch.Tensor]]:
    """Plane twin of tracking.fsk_track_apply: Gardner timing on the
    discriminator stream (the imag plane is zero, so the loop runs on the
    real plane alone). x_planes: [C, 2, N] -> (state, (bits, soft))."""
    br, bi, hist, word = _front_planes(params, state.word, state.hist, x_planes)
    pr, pi, xr = _fsk_disc_planes(params, br, bi, state.disc_r, state.disc_i, state.tail)
    tau, freq, y = gardner_planes(state.gardner.tau, state.gardner.freq, xr[:, None],
                                  params.sps, kp, ki)
    g_s = GardnerState(tau=tau, freq=freq)
    sr = y[:, 0]
    bits = (sr > 0).to(torch.int32)
    return FskTrackPlanesState(word=word, hist=hist, disc_r=pr, disc_i=pi,
                               tail=xr[..., xr.shape[-1] - params.sps:],
                               gardner=g_s), (bits, sr)


class PskTrackRaggedPlanesState(NamedTuple):
    word: torch.Tensor
    hist: torch.Tensor
    tail_r: torch.Tensor
    tail_i: torch.Tensor
    gardner: GardnerFreePlanesState
    costas: CostasState


def psk_track_ragged_planes_init(params: PskParams, num_channels: int,
                                 tau0: float = 0.0) -> PskTrackRaggedPlanesState:
    dev = params.taps.device
    return PskTrackRaggedPlanesState(
        word=torch.zeros((num_channels, 1), dtype=torch.int64, device=dev),
        hist=torch.zeros((num_channels, 2, _hist_len(params)), dtype=F32, device=dev),
        tail_r=torch.zeros((num_channels, params.sps), dtype=F32, device=dev),
        tail_i=torch.zeros((num_channels, params.sps), dtype=F32, device=dev),
        gardner=gardner_free_init_planes((num_channels,), tau0=tau0, device=dev),
        costas=costas_init((num_channels,), device=dev))


def psk_track_ragged_planes_apply(params: PskParams, state: PskTrackRaggedPlanesState,
                                  x_planes: torch.Tensor, kp: float = 0.2, ki: float = 0.02,
                                  max_dev: float = 0.05
                                  ) -> tuple[PskTrackRaggedPlanesState,
                                             tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                                   torch.Tensor]]:
    """Plane twin of tracking.psk_track_ragged_apply (skip/stuff: the
    emitted symbol count follows the clock; static capacity + validity
    mask). Returns (state, (idx, soft_r, soft_i, valid)); feed (idx, valid)
    to tracking.compact_ragged at the sink."""
    off = constellation_offset(params.order)
    br, bi, hist, word = _front_planes(params, state.word, state.hist, x_planes)
    xr = torch.cat([state.tail_r, br], dim=-1)
    xi = torch.cat([state.tail_i, bi], dim=-1)
    g_s, (sr, si, valid) = gardner_free_scan_planes(state.gardner, xr, xi, params.sps, kp=kp,
                                                    ki=ki, max_dev=max_dev)
    c_s, (yr, yi) = costas_scan_planes(state.costas, sr, si, params.order, offset=off,
                                       valid=valid)
    idx = psk_slice_planes(yr, yi, params.order, off)
    return PskTrackRaggedPlanesState(word=word, hist=hist,
                                     tail_r=xr[..., xr.shape[-1] - params.sps:],
                                     tail_i=xi[..., xi.shape[-1] - params.sps:], gardner=g_s,
                                     costas=c_s), (idx, yr, yi, valid)


class FskTrackRaggedPlanesState(NamedTuple):
    word: torch.Tensor
    hist: torch.Tensor
    disc_r: torch.Tensor
    disc_i: torch.Tensor
    tail: torch.Tensor
    gardner: GardnerFreePlanesState


def fsk_track_ragged_planes_init(params: FskParams, num_channels: int,
                                 tau0: float = 0.0) -> FskTrackRaggedPlanesState:
    dev = params.taps.device
    z1 = torch.zeros((num_channels, 1), dtype=F32, device=dev)
    return FskTrackRaggedPlanesState(
        word=torch.zeros((num_channels, 1), dtype=torch.int64, device=dev),
        hist=torch.zeros((num_channels, 2, _hist_len(params)), dtype=F32, device=dev),
        disc_r=z1, disc_i=z1,
        tail=torch.zeros((num_channels, params.sps), dtype=F32, device=dev),
        gardner=gardner_free_init_planes((num_channels,), tau0=tau0, device=dev))


def fsk_track_ragged_planes_apply(params: FskParams, state: FskTrackRaggedPlanesState,
                                  x_planes: torch.Tensor, kp: float = 0.05, ki: float = 0.002,
                                  max_dev: float = 0.05
                                  ) -> tuple[FskTrackRaggedPlanesState,
                                             tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Plane twin of tracking.fsk_track_ragged_apply (the real plane alone
    through the loop, as in `fsk_track_planes_apply`)."""
    br, bi, hist, word = _front_planes(params, state.word, state.hist, x_planes)
    pr, pi, xr = _fsk_disc_planes(params, br, bi, state.disc_r, state.disc_i, state.tail)
    g = state.gardner
    (pos, freq, prev), (y, valid) = gardner_free_planes(
        g.pos, g.freq, g.prev_r[:, None], xr[:, None], params.sps, kp, ki, max_dev)
    sr = y[:, 0]
    bits = (sr > 0).to(torch.int32)
    # the imag plane stays zero, so prev_i does too
    g_s = GardnerFreePlanesState(pos=pos, freq=freq, prev_r=prev[:, 0], prev_i=g.prev_i)
    return FskTrackRaggedPlanesState(word=word, hist=hist, disc_r=pr, disc_i=pi,
                                     tail=xr[..., xr.shape[-1] - params.sps:],
                                     gardner=g_s), (bits, sr, valid)
