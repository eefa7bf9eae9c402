"""pi/4-DQPSK demodulator (TETRA/PDC/IS-54 style) (counterpart of
``srcdsp_tpu/chains/dqpsk.py``).

Reuses the PSK front end (NCO mix -> RRC matched filter -> O&M timing,
``chains.psk``) but replaces carrier recovery: the dibit rides the phase
difference between consecutive symbols (delta = (2d+1)*pi/4, d in 0..3), so
the demod is one conjugate product z[k] = y[k] * conj(y[k-1]) and an angle
slice. A residual CFO only biases every delta by the same constant.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from srcdsp_tpu_torch.chains.psk import PskParams, make_psk_params
from srcdsp_tpu_torch.chains.sync import TimingState, timing_estimate, timing_init, timing_sample
from srcdsp_tpu_torch.ops.fir import FirState, fir_apply, fir_init
from srcdsp_tpu_torch.ops.nco import TWO_PI, NcoState, nco_apply, nco_init
from srcdsp_tpu_torch.ops.window import root_raised_cosine
from srcdsp_tpu_torch.types import CF32, F32

__all__ = ["DqpskState", "make_dqpsk_params", "dqpsk_init", "dqpsk_apply",
           "dqpsk_demod_stream", "dqpsk_slice", "dqpsk_baseband"]


class DqpskState(NamedTuple):
    nco: NcoState
    fir: FirState
    timing: TimingState
    prev: torch.Tensor     # [...] complex64: last symbol of the previous block


def make_dqpsk_params(center_freq: float, decim: int, sps: int, rrc_beta: float = 0.35,
                      rrc_span: int = 8, device=None) -> PskParams:
    """The M-PSK front-end parameters (order fixed at 4) on `device` (None =
    the card)."""
    return make_psk_params(center_freq, decim, sps, order=4, rrc_beta=rrc_beta,
                           rrc_span=rrc_span, device=device)


def dqpsk_init(params: PskParams, channel_shape: tuple = ()) -> DqpskState:
    """Zero state on the params' device."""
    dev = params.taps.device
    return DqpskState(nco=nco_init(channel_shape, device=dev),
                      fir=fir_init(int(params.taps.shape[-1]), channel_shape, device=dev),
                      timing=timing_init(params.sps, channel_shape, dtype=CF32, device=dev),
                      prev=torch.zeros(channel_shape, dtype=CF32, device=dev))


def dqpsk_slice(z: torch.Tensor) -> torch.Tensor:
    """Map conjugate products to dibits: angle (2d+1)*pi/4 -> d.

    floor(angle/(pi/4)) is in {-4..3}, and d = ((floor + 4) // 2 + 2) mod 4
    maps (0,pi/2)->0, (pi/2,pi)->1, (-pi,-pi/2)->2, (-pi/2,0)->3."""
    idx = torch.floor(torch.angle(z) * (4.0 / TWO_PI) * 2.0).to(torch.int32)
    return torch.remainder(torch.div(idx + 4, 2, rounding_mode="floor") + 2, 4)


def dqpsk_apply(params: PskParams, state: DqpskState, x: torch.Tensor
                ) -> tuple[DqpskState, tuple[torch.Tensor, torch.Tensor]]:
    """Demodulate one block. x: [..., N], N % (decim*sps) == 0.

    Returns (state, (dibits [..., Nsym] int32, z [..., Nsym] complex64)),
    z the conjugate-product soft symbol. The first symbol of the first block
    differences against 0 and is a reference.
    """
    nco_s, mixed = nco_apply(params.freq_word, state.nco, x)
    fir_s, bb = fir_apply(params.taps, state.fir, mixed, decim=params.decim)
    power = (bb.real ** 2 + bb.imag ** 2).to(F32)
    acc, tau = timing_estimate(state.timing.acc, power, params.sps)
    t_last, sym = timing_sample(state.timing.last, bb, tau, params.sps)
    prev = torch.cat([state.prev[..., None], sym[..., :-1]], dim=-1)
    z = (sym * torch.conj(prev)).to(CF32)
    return (DqpskState(nco=nco_s, fir=fir_s, timing=TimingState(acc=acc, last=t_last),
                       prev=sym[..., -1]),
            (dqpsk_slice(z), z))


def dqpsk_demod_stream(params: PskParams, x: torch.Tensor, block: int,
                       channel_shape: tuple = ()) -> tuple[torch.Tensor, torch.Tensor]:
    """Whole-capture convenience: dqpsk_apply over `block`-sample chunks
    with the state carried (the reference's scan as a loop)."""
    s = x.shape[-1]
    if s % block != 0:
        raise ValueError(f"capture length {s} not divisible by block {block}")
    st = dqpsk_init(params, channel_shape)
    idx, zs = [], []
    for b0 in range(0, s, block):
        st, (i, z) = dqpsk_apply(params, st, x[..., b0:b0 + block])
        idx.append(i)
        zs.append(z)
    return torch.cat(idx, dim=-1), torch.cat(zs, dim=-1)


def dqpsk_baseband(dibits: np.ndarray, sps_total: int, rrc_beta: float = 0.35,
                   rrc_span: int = 8) -> np.ndarray:
    """Transmit fixture (host numpy): pi/4-DQPSK pulse-shaped baseband at
    sps_total samples/symbol (phase starts at 0; symbol k advances by
    (2*dibits[k]+1)*pi/4)."""
    d = np.asarray(dibits)
    dphi = (2.0 * d + 1.0) * (np.pi / 4.0)
    phases = np.cumsum(dphi, axis=-1)
    syms = np.exp(1j * phases).astype(np.complex64)
    up = np.zeros((*syms.shape[:-1], syms.shape[-1] * sps_total), np.complex64)
    up[..., ::sps_total] = syms
    h = root_raised_cosine(sps_total, rrc_span, beta=rrc_beta)
    pad = np.zeros((*up.shape[:-1], h.size - 1), np.complex64)
    full = np.concatenate([up, pad], axis=-1)
    out = np.empty_like(full)
    for idx0 in np.ndindex(*full.shape[:-1]):
        out[idx0] = np.convolve(full[idx0], h)[: full.shape[-1]]
    return out * np.float32(sps_total)
