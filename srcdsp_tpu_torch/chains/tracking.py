"""Tracking-mode demod chains (counterpart of ``srcdsp_tpu/chains/tracking.py``):
closed-loop timing and carrier recovery on the complex tier.

The feedforward estimators in ``chains.fsk`` / ``chains.psk`` average one tau
and one phase per block. When the symbol clock drifts inside a block, these
chains swap in the per-symbol loops of ``chains.sync_loop`` (Gardner TED +
2nd-order loop; M-power Costas).

Two timing modes:

- `psk_track_apply` / `fsk_track_apply` (bounded wander): exactly
  N/(decim*sps) symbols per block;
- `psk_track_ragged_apply` / `fsk_track_ragged_apply` (skip/stuff,
  unbounded sustained ppm offsets): the strobe free-runs, so a fast clock
  emits more symbols; the output is a static capacity
  (``gardner_free_cap``) with a per-strobe validity mask, and
  `compact_ragged` squeezes it on the host at the sink.

Each chain carries an sps-sample tail and prepends it, so the next block's
first strobe re-covers the carried symbol and no symbol drops at a seam.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from srcdsp_tpu_torch.chains.fsk import FskParams, discriminate
from srcdsp_tpu_torch.chains.psk import PskParams, constellation_offset, psk_slice
from srcdsp_tpu_torch.chains.sync_loop import (
    CostasState, GardnerFreeState, GardnerState, costas_init, costas_scan, gardner_free_init,
    gardner_free_scan, gardner_init, gardner_scan)
from srcdsp_tpu_torch.ops.fir import FirState, fir_apply, fir_init
from srcdsp_tpu_torch.ops.nco import NcoState, nco_apply, nco_init
from srcdsp_tpu_torch.types import CF32, F32


def _front(params, nco_s, fir_s, x):
    """NCO mix, then the channel / matched filter with decimation."""
    nco_s, mixed = nco_apply(params.freq_word, nco_s, x)
    fir_s, bb = fir_apply(params.taps, fir_s, mixed, decim=params.decim)
    return nco_s, fir_s, bb


def _fsk_disc(params: FskParams, disc_last, bb, tail):
    """Discriminator normalised to about +-1 (the Gardner error scales with
    the square of the amplitude), after the carried tail: (disc_last, xin)."""
    disc_last, d = discriminate(disc_last, bb)
    d = d * np.float32(1.0 / params.dev)
    return disc_last, torch.cat([tail, d.to(CF32)], dim=-1)


class PskTrackState(NamedTuple):
    nco: NcoState
    fir: FirState
    tail: torch.Tensor      # [..., sps] carried post-filter samples
    gardner: GardnerState
    costas: CostasState


def psk_track_init(params: PskParams, channel_shape: tuple = (),
                   tau0: float = 0.0) -> PskTrackState:
    dev = params.taps.device
    return PskTrackState(
        nco=nco_init(channel_shape, device=dev),
        fir=fir_init(int(params.taps.shape[-1]), channel_shape, device=dev),
        tail=torch.zeros((*channel_shape, params.sps), dtype=CF32, device=dev),
        gardner=gardner_init(channel_shape, tau0=tau0, device=dev),
        costas=costas_init(channel_shape, device=dev))


def psk_track_apply(params: PskParams, state: PskTrackState, x: torch.Tensor,
                    kp: float = 0.2, ki: float = 0.02
                    ) -> tuple[PskTrackState, tuple[torch.Tensor, torch.Tensor]]:
    """Demodulate one block with closed-loop timing + carrier tracking.

    x: [..., N], N % (decim*sps) == 0. Returns (state, (idx, soft)) with
    exactly N/(decim*sps) symbols per block.
    """
    off = constellation_offset(params.order)
    nco_s, fir_s, bb = _front(params, state.nco, state.fir, x)
    xin = torch.cat([state.tail, bb], dim=-1)
    g_s, sym = gardner_scan(state.gardner, xin, params.sps, kp=kp, ki=ki)
    c_s, soft = costas_scan(state.costas, sym, params.order, offset=off)
    idx = psk_slice(soft, params.order, off)
    return PskTrackState(nco=nco_s, fir=fir_s, tail=xin[..., xin.shape[-1] - params.sps:],
                         gardner=g_s, costas=c_s), (idx, soft)


class FskTrackState(NamedTuple):
    nco: NcoState
    fir: FirState
    disc_last: torch.Tensor  # [..., 1] complex64
    tail: torch.Tensor       # [..., sps] carried discriminator samples (complex64)
    gardner: GardnerState


def fsk_track_init(params: FskParams, channel_shape: tuple = (),
                   tau0: float = 0.0) -> FskTrackState:
    dev = params.taps.device
    return FskTrackState(
        nco=nco_init(channel_shape, device=dev),
        fir=fir_init(int(params.taps.shape[-1]), channel_shape, device=dev),
        disc_last=torch.zeros((*channel_shape, 1), dtype=CF32, device=dev),
        tail=torch.zeros((*channel_shape, params.sps), dtype=CF32, device=dev),
        gardner=gardner_init(channel_shape, tau0=tau0, device=dev))


def fsk_track_apply(params: FskParams, state: FskTrackState, x: torch.Tensor,
                    kp: float = 0.05, ki: float = 0.002
                    ) -> tuple[FskTrackState, tuple[torch.Tensor, torch.Tensor]]:
    """FSK demod with Gardner timing on the discriminator output (imag 0).

    Same carried sps-tail as `psk_track_apply`: exactly N/(decim*sps) bits
    per block. Gentler default gains: the discriminator's transition spikes
    are TED self-noise.
    """
    nco_s, fir_s, bb = _front(params, state.nco, state.fir, x)
    disc_last, xin = _fsk_disc(params, state.disc_last, bb, state.tail)
    g_s, sym = gardner_scan(state.gardner, xin, params.sps, kp=kp, ki=ki)
    soft = sym.real.to(F32)
    bits = (soft > 0).to(torch.int32)
    return FskTrackState(nco=nco_s, fir=fir_s, disc_last=disc_last,
                         tail=xin[..., xin.shape[-1] - params.sps:], gardner=g_s), (bits, soft)


class PskTrackRaggedState(NamedTuple):
    nco: NcoState
    fir: FirState
    tail: torch.Tensor
    gardner: GardnerFreeState
    costas: CostasState


def psk_track_ragged_init(params: PskParams, channel_shape: tuple = (),
                          tau0: float = 0.0) -> PskTrackRaggedState:
    dev = params.taps.device
    return PskTrackRaggedState(
        nco=nco_init(channel_shape, device=dev),
        fir=fir_init(int(params.taps.shape[-1]), channel_shape, device=dev),
        tail=torch.zeros((*channel_shape, params.sps), dtype=CF32, device=dev),
        gardner=gardner_free_init(channel_shape, tau0=tau0, device=dev),
        costas=costas_init(channel_shape, device=dev))


def psk_track_ragged_apply(params: PskParams, state: PskTrackRaggedState, x: torch.Tensor,
                           kp: float = 0.2, ki: float = 0.02, max_dev: float = 0.05
                           ) -> tuple[PskTrackRaggedState,
                                      tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Skip/stuff PSK demod: tolerates unbounded sustained clock offsets.

    x: [..., N], N % decim == 0. Returns (state, (idx, soft, valid)) with
    capacity gardner_free_cap(N/decim, sps, max_dev) symbols per block;
    invalid lanes hold frozen values. Feed (idx, valid) to `compact_ragged`.
    """
    off = constellation_offset(params.order)
    nco_s, fir_s, bb = _front(params, state.nco, state.fir, x)
    xin = torch.cat([state.tail, bb], dim=-1)
    g_s, (sym, valid) = gardner_free_scan(state.gardner, xin, params.sps, kp=kp, ki=ki,
                                          max_dev=max_dev)
    c_s, soft = costas_scan(state.costas, sym, params.order, offset=off, valid=valid)
    idx = psk_slice(soft, params.order, off)
    return PskTrackRaggedState(nco=nco_s, fir=fir_s,
                               tail=xin[..., xin.shape[-1] - params.sps:],
                               gardner=g_s, costas=c_s), (idx, soft, valid)


class FskTrackRaggedState(NamedTuple):
    nco: NcoState
    fir: FirState
    disc_last: torch.Tensor
    tail: torch.Tensor
    gardner: GardnerFreeState


def fsk_track_ragged_init(params: FskParams, channel_shape: tuple = (),
                          tau0: float = 0.0) -> FskTrackRaggedState:
    dev = params.taps.device
    return FskTrackRaggedState(
        nco=nco_init(channel_shape, device=dev),
        fir=fir_init(int(params.taps.shape[-1]), channel_shape, device=dev),
        disc_last=torch.zeros((*channel_shape, 1), dtype=CF32, device=dev),
        tail=torch.zeros((*channel_shape, params.sps), dtype=CF32, device=dev),
        gardner=gardner_free_init(channel_shape, tau0=tau0, device=dev))


def fsk_track_ragged_apply(params: FskParams, state: FskTrackRaggedState, x: torch.Tensor,
                           kp: float = 0.05, ki: float = 0.002, max_dev: float = 0.05
                           ) -> tuple[FskTrackRaggedState,
                                      tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Skip/stuff FSK demod (see `psk_track_ragged_apply`)."""
    nco_s, fir_s, bb = _front(params, state.nco, state.fir, x)
    disc_last, xin = _fsk_disc(params, state.disc_last, bb, state.tail)
    g_s, (sym, valid) = gardner_free_scan(state.gardner, xin, params.sps, kp=kp, ki=ki,
                                          max_dev=max_dev)
    soft = sym.real.to(F32)
    bits = (soft > 0).to(torch.int32)
    return FskTrackRaggedState(nco=nco_s, fir=fir_s, disc_last=disc_last,
                               tail=xin[..., xin.shape[-1] - params.sps:],
                               gardner=g_s), (bits, soft, valid)


def compact_ragged(vals, valid):
    """Host-side sink: squeeze a masked capacity stream to the true symbols.

    vals/valid: [..., K] tensors or arrays from one or more blocks
    (concatenate blocks along the last axis first). 1-D returns a numpy
    array; with leading channel dims, a list per channel (counts differ:
    that is the point of skip/stuff)."""
    def host(a):
        return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

    v = host(vals)
    m = host(valid).astype(bool)
    if v.ndim == 1:
        return v[m]
    flat_v = v.reshape(-1, v.shape[-1])
    flat_m = m.reshape(-1, m.shape[-1])
    return [fv[fm] for fv, fm in zip(flat_v, flat_m)]
