"""M-PSK demodulator chain (counterpart of ``srcdsp_tpu/chains/psk.py``).

Feedforward Viterbi&Viterbi carrier recovery instead of a per-sample Costas
loop: one power, one reduction and one rotate per block.

    acc   = forget*acc + sum_k s_k^M * exp(-j*2*pi*off)   (carried, circular)
    phi   = angle(acc) / M                                 (block phase)
    y_k   = s_k * exp(-j*phi)                              (derotate)
    idx_k = round(angle(y_k)*M/(2*pi) - off) mod M         (slice)

Constellation: point m is exp(j*2*pi*(m+off)/M), off = 0.5 for QPSK, else 0
(``testing.signals.psk_symbols``). V&V leaves an M-fold phase ambiguity;
`diff_encode`/`diff_decode` resolve it.

Chain: NCO mix -> RRC matched filter (+decimate) -> O&M symbol timing ->
V&V carrier recovery -> slicer. Channels are leading axes.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from srcdsp_tpu_torch.chains.sync import (
    TimingState, fixed_sum, timing_estimate, timing_init, timing_sample)
from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.ops.cpow import cpow
from srcdsp_tpu_torch.ops.fir import FirState, fir_apply, fir_init
from srcdsp_tpu_torch.ops.nco import NcoState, TWO_PI, freq_to_word, nco_apply, nco_init, word_tensor
from srcdsp_tpu_torch.ops.window import root_raised_cosine
from srcdsp_tpu_torch.types import CF32, F32


def constellation_offset(order: int) -> float:
    return 0.5 if order == 4 else 0.0


@dataclasses.dataclass(frozen=True)
class PskParams:
    freq_word: torch.Tensor   # int64 u32 NCO word(s): shift the channel to baseband
    taps: torch.Tensor        # [T] float32 matched-filter (RRC) taps
    decim: int
    sps: int                  # post-decimation samples per symbol
    order: int                # M in M-PSK


class PskState(NamedTuple):
    nco: NcoState
    fir: FirState
    timing: TimingState
    cr_acc: torch.Tensor      # [...] complex64 V&V phase accumulator


def make_psk_params(center_freq: float, decim: int, sps: int, order: int = 4,
                    rrc_beta: float = 0.35, rrc_span: int = 8, device=None) -> PskParams:
    """Host-side constructor. The RRC is designed at the input rate
    (decim*sps samples/symbol), so matched filtering happens before decimation."""
    device = resolve(device)
    taps = root_raised_cosine(decim * sps, rrc_span, beta=rrc_beta)
    return PskParams(freq_word=word_tensor(freq_to_word(-center_freq), device),
                     taps=torch.as_tensor(taps, device=device), decim=decim, sps=sps,
                     order=order)


def psk_init(params: PskParams, channel_shape: tuple = ()) -> PskState:
    dev = params.taps.device
    return PskState(
        nco=nco_init(channel_shape, device=dev),
        fir=fir_init(int(params.taps.shape[-1]), channel_shape, device=dev),
        timing=timing_init(params.sps, channel_shape, dtype=CF32, device=dev),
        cr_acc=torch.zeros(channel_shape, dtype=CF32, device=dev),
    )


def vv_phase(acc: torch.Tensor, sym: torch.Tensor, order: int, off: float,
             forget: float = 0.5) -> tuple[torch.Tensor, torch.Tensor]:
    """Viterbi&Viterbi block phase estimate with a carried circular accumulator."""
    powered = torch.complex(*cpow(sym.real, sym.imag, order))
    rot = torch.exp(torch.tensor(-1j * TWO_PI * off, dtype=CF32, device=sym.device))
    c = fixed_sum(powered * rot)
    acc = (np.float32(forget) * acc + c).to(CF32)
    return acc, torch.angle(acc) / order


def psk_slice(y: torch.Tensor, order: int, off: float) -> torch.Tensor:
    """Nearest-constellation-point indices (int32) for derotated symbols."""
    idx = torch.round(torch.angle(y) * np.float32(order / TWO_PI) - np.float32(off))
    return torch.remainder(idx.to(torch.int32), order)


def psk_apply(params: PskParams, state: PskState, x: torch.Tensor
              ) -> tuple[PskState, tuple[torch.Tensor, torch.Tensor]]:
    """Demodulate one block. x: [..., N], N % (decim*sps) == 0.

    Returns (state, (sym_idx [..., Nsym] int32, soft [..., Nsym] complex64));
    soft is the derotated symbol at unit-circle scale.
    """
    off = constellation_offset(params.order)
    nco_s, mixed = nco_apply(params.freq_word, state.nco, x)
    fir_s, bb = fir_apply(params.taps, state.fir, mixed, decim=params.decim)
    power = (bb.real ** 2 + bb.imag ** 2).to(F32)
    acc, tau = timing_estimate(state.timing.acc, power, params.sps)
    t_last, sym = timing_sample(state.timing.last, bb, tau, params.sps)
    # normalise the amplitude so the M-th power does not overweight peaks
    scale = torch.sqrt(torch.mean(torch.abs(sym) ** 2, dim=-1, keepdim=True) + 1e-12)
    symn = (sym / scale).to(CF32)
    cr_acc, phi = vv_phase(state.cr_acc, symn, params.order, off)
    soft = (symn * torch.exp(-1j * phi[..., None])).to(CF32)
    idx = psk_slice(soft, params.order, off)
    new_state = PskState(nco=nco_s, fir=fir_s, timing=TimingState(acc=acc, last=t_last),
                         cr_acc=cr_acc)
    return new_state, (idx, soft)


def psk_demod_stream(params: PskParams, x: torch.Tensor, block: int,
                     channel_shape: tuple = ()) -> tuple[torch.Tensor, torch.Tensor]:
    """Whole-capture convenience: psk_apply over blocks of `block` samples
    (the reference's scan as a loop).

    x: [..., S] with S % block == 0 and block % (decim*sps) == 0.
    Returns (sym_idx [..., S/(decim*sps)], soft).
    """
    s = x.shape[-1]
    if s % block != 0:
        raise ValueError(f"capture length {s} not divisible by block {block}")
    st = psk_init(params, channel_shape)
    idx, soft = [], []
    for b0 in range(0, s, block):
        st, (i, sf) = psk_apply(params, st, x[..., b0:b0 + block])
        idx.append(i)
        soft.append(sf)
    return torch.cat(idx, dim=-1), torch.cat(soft, dim=-1)


def diff_encode(idx: torch.Tensor, order: int) -> torch.Tensor:
    """Differential encoding: tx[k] = cumsum(idx) mod M (resolves V&V ambiguity)."""
    return torch.remainder(torch.cumsum(idx.to(torch.int64), dim=-1), order).to(idx.dtype)


def diff_decode(idx: torch.Tensor, order: int) -> torch.Tensor:
    """d[k] = idx[k] - idx[k-1] mod M; d[0] uses idx[-1] = 0 (first symbol is a ref)."""
    prev = torch.cat([torch.zeros_like(idx[..., :1]), idx[..., :-1]], dim=-1)
    return torch.remainder(idx - prev, order)
