"""FSK demodulator chain (counterpart of ``srcdsp_tpu/chains/fsk.py``).

mix -> channel filter + decimate -> atan2 frequency discriminator ->
Oerder & Meyr symbol timing -> bit slicer, vectorized over whole blocks
with carried state; channels are leading axes, never objects. This is the
portable complex tier; the serving kernels live in ``kernels/``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from srcdsp_tpu_torch.chains.sync import TimingState, timing_estimate, timing_init, timing_sample
from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.ops.fir import FirState, fir_apply, fir_init
from srcdsp_tpu_torch.ops.nco import NcoState, TWO_PI, freq_to_word, nco_apply, nco_init, word_tensor
from srcdsp_tpu_torch.ops.window import lowpass
from srcdsp_tpu_torch.types import CF32, F32


@dataclasses.dataclass(frozen=True)
class FskParams:
    """Per-chain parameters. `freq_word` may carry leading channel axes."""

    freq_word: torch.Tensor   # int64 u32 NCO tuning word(s): shift channel to 0
    taps: torch.Tensor        # [T] float32 channel-filter taps (shared)
    decim: int
    sps: int
    dev: float
    # Timing-accumulator memory (chains.sync forgetting factor): 0.5 for
    # square-pulse FSK, ~0.9-1.0 for smooth CPM.
    timing_forget: float = 0.5


class FskState(NamedTuple):
    nco: NcoState
    fir: FirState
    disc_last: torch.Tensor   # [..., 1] complex64: last filtered sample
    timing: TimingState


def make_fsk_params(center_freq: float, num_taps: int, cutoff: float,
                    decim: int, sps: int, dev: float,
                    window: str = "hamming",
                    timing_forget: float = 0.5, device=None) -> FskParams:
    """Host-side constructor: design taps, quantize the NCO word.

    center_freq: channel offset in cycles/sample at the *input* rate; the NCO
    mixes by -center_freq so the channel lands at baseband.
    """
    device = resolve(device)
    return FskParams(
        freq_word=word_tensor(freq_to_word(-center_freq), device),
        taps=torch.as_tensor(lowpass(num_taps, cutoff, window=window), device=device),
        decim=decim, sps=sps, dev=dev, timing_forget=timing_forget,
    )


def fsk_init(params: FskParams, channel_shape: tuple = ()) -> FskState:
    dev = params.taps.device
    return FskState(
        nco=nco_init(channel_shape, device=dev),
        fir=fir_init(int(params.taps.shape[-1]), channel_shape, device=dev),
        disc_last=torch.zeros((*channel_shape, 1), dtype=CF32, device=dev),
        timing=timing_init(params.sps, channel_shape, dtype=F32, device=dev),
    )


def discriminate(last: torch.Tensor, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Instantaneous frequency in cycles/sample: angle(x[n]*conj(x[n-1]))/2pi.

    `last` carries x[-1] of the previous block, so there is no block seam.
    """
    xin = torch.cat([last, x], dim=-1)
    d = torch.angle(xin[..., 1:] * torch.conj(xin[..., :-1])) * np.float32(1.0 / TWO_PI)
    return x[..., -1:], d.to(F32)


def fsk_apply(params: FskParams, state: FskState, x: torch.Tensor,
              ) -> tuple[FskState, tuple[torch.Tensor, torch.Tensor]]:
    """Demodulate one block. x: [..., N], N % (decim*sps) == 0.

    Returns (state, (bits [..., Nsym] int32, soft [..., Nsym] float32)); soft
    is the interpolated discriminator output in cycles/sample.
    """
    nco_s, mixed = nco_apply(params.freq_word, state.nco, x)
    fir_s, bb = fir_apply(params.taps, state.fir, mixed, decim=params.decim)
    disc_last, d = discriminate(state.disc_last, bb)
    acc, tau = timing_estimate(state.timing.acc, d * d, params.sps,
                               forget=params.timing_forget)
    t_last, soft = timing_sample(state.timing.last, d, tau, params.sps)
    bits = (soft > 0).to(torch.int32)
    new_state = FskState(nco=nco_s, fir=fir_s, disc_last=disc_last,
                         timing=TimingState(acc=acc, last=t_last))
    return new_state, (bits, soft)


def fsk_demod_stream(params: FskParams, x: torch.Tensor, block: int,
                     channel_shape: tuple = ()) -> tuple[torch.Tensor, torch.Tensor]:
    """Whole-capture convenience: fsk_apply over blocks of `block` samples.

    x: [..., S] with S % block == 0 and block % (decim*sps) == 0.
    """
    s = x.shape[-1]
    if s % block != 0:
        raise ValueError(f"capture length {s} not divisible by block {block}")
    st = fsk_init(params, channel_shape)
    bits, soft = [], []
    for b0 in range(0, s, block):
        st, (b, sf) = fsk_apply(params, st, x[..., b0:b0 + block])
        bits.append(b)
        soft.append(sf)
    return torch.cat(bits, dim=-1), torch.cat(soft, dim=-1)
