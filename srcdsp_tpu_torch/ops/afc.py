"""Band-edge AFC: automatic frequency control with a pull-in range of the
full symbol bandwidth (counterpart of ``srcdsp_tpu/ops/afc.py``).

Block feedback: two one-sided complex-tap FIRs sit on the upper and lower
band edges of the pulse-shaped signal; per block the normalized power
imbalance e = (Pu - Pl)/(Pu + Pl) is an S-curve in the residual frequency
offset across the whole signal bandwidth, and the estimate moves once per
block (freq += gain * e * bw/2). The derotation's tuning word is made from
the estimate on the device (``ops.nco.freq_to_word_traced``), so the phase
stays continuous through the carried u32 accumulator while the frequency
changes from block to block.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.ops.fir import FirState, fir_apply, fir_init
from srcdsp_tpu_torch.ops.nco import NcoState, freq_to_word_traced, nco_apply, nco_init
from srcdsp_tpu_torch.ops.window import lowpass
from srcdsp_tpu_torch.types import F32

__all__ = ["AfcParams", "AfcState", "make_afc", "afc_init", "afc_apply"]


class AfcParams(NamedTuple):
    upper_taps: torch.Tensor   # [T] complex one-sided edge filter (+)
    lower_taps: torch.Tensor   # [T] complex one-sided edge filter (-)
    bw: float                  # signal bandwidth, cycles/sample
    gain: float                # loop gain; 0.1 converges in ~5 blocks


class AfcState(NamedTuple):
    freq: torch.Tensor         # [] f32 current frequency estimate
    nco: NcoState
    up: FirState
    lo: FirState


def make_afc(symbol_rate: float, beta: float = 0.35, num_taps: int = 64, gain: float = 0.1,
             device=None) -> AfcParams:
    """symbol_rate in cycles/sample (1/sps); beta = excess bandwidth of the
    pulse shaping. The edge filters sit at +-(1+beta)*Rs/2 with a bandwidth
    of beta*Rs (at least Rs/8), over the rolloff skirt."""
    bw = (1.0 + beta) * symbol_rate
    edge = bw / 2.0
    ebw = max(beta * symbol_rate, symbol_rate / 8.0)
    if edge + ebw / 2.0 >= 0.5:
        raise ValueError(
            f"band-edge filter would alias: (1+beta)*Rs/2 + edge_bw/2 = "
            f"{edge + ebw / 2.0:.3f} >= 0.5 — increase the oversampling")
    proto = lowpass(num_taps, ebw / 2.0)
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    device = resolve(device)
    up = torch.as_tensor((proto * np.exp(2j * np.pi * edge * n)).astype(np.complex64),
                         device=device)
    lo = torch.as_tensor((proto * np.exp(-2j * np.pi * edge * n)).astype(np.complex64),
                         device=device)
    return AfcParams(upper_taps=up, lower_taps=lo, bw=float(bw), gain=float(gain))


def afc_init(params: AfcParams, freq0: float = 0.0, device=None) -> AfcState:
    device = resolve(device)
    t = int(params.upper_taps.shape[-1])
    return AfcState(freq=torch.tensor(np.float32(freq0), device=device),
                    nco=nco_init(device=device), up=fir_init(t, device=device),
                    lo=fir_init(t, device=device))


def afc_apply(params: AfcParams, state: AfcState, x: torch.Tensor
              ) -> tuple[AfcState, tuple[torch.Tensor, torch.Tensor]]:
    """One block: derotate by the current estimate, measure the band-edge
    imbalance, update the estimate once. Returns (state, (y, freq)): y is the
    derotated block, freq the estimate before this block's update."""
    nco_s, y = nco_apply(freq_to_word_traced(-state.freq), state.nco, x)
    up_s, u = fir_apply(params.upper_taps, state.up, y)
    lo_s, l = fir_apply(params.lower_taps, state.lo, y)
    pu = torch.mean(torch.abs(u) ** 2)
    pl = torch.mean(torch.abs(l) ** 2)
    e = (pu - pl) / (pu + pl + np.float32(1e-20))
    freq2 = state.freq + np.float32(params.gain * params.bw / 2.0) * e.to(F32)
    return AfcState(freq=freq2, nco=nco_s, up=up_s, lo=lo_s), (y, state.freq)
