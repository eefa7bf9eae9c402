"""Symbol-timing synchronization (counterpart of ``srcdsp_tpu/chains/sync.py``).

Feedforward Oerder & Meyr block synchronizer (square-law timing tone):

    C      = sum_n s[n] * exp(-j*2*pi*n/sps)        (one reduction)
    tau    = -sps/(2*pi) * angle(C)  (mod sps)       (peak-energy offset)

The complex accumulator C is carried across blocks with a one-pole
forgetting factor; every block length is a multiple of sps, so the
local-index tone is phase-continuous. Symbol values are read at
t_k = k*sps + tau by linear interpolation (a gather).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.ops.nco import TWO_PI
from srcdsp_tpu_torch.types import CF32, F32


class TimingState(NamedTuple):
    """Carried timing-tone accumulator (complex) and an sps+1-sample tail."""

    acc: torch.Tensor   # [...] complex64 timing-tone accumulator
    last: torch.Tensor  # [..., sps+1] same dtype as the sampled signal


def timing_init(sps: int, channel_shape: tuple = (), dtype=CF32, device=None) -> TimingState:
    device = resolve(device)
    return TimingState(
        acc=torch.zeros(channel_shape, dtype=CF32, device=device),
        last=torch.zeros((*channel_shape, sps + 1), dtype=dtype, device=device),
    )


def timing_estimate(state_acc: torch.Tensor, metric: torch.Tensor, sps: int,
                    forget: float = 0.5) -> tuple[torch.Tensor, torch.Tensor]:
    """Update the timing accumulator from one block's timing metric.

    metric: [..., N] non-negative, N % sps == 0. Returns (new_acc, tau) with
    tau in [0, sps) per channel.
    """
    n = metric.shape[-1]
    if n % sps != 0:
        raise ValueError(f"block length {n} not divisible by sps {sps}")
    # reduce the index mod sps BEFORE the float angle (f32 rounding at large k)
    k = torch.remainder(torch.arange(n, dtype=F32, device=metric.device), sps)
    tone = torch.exp((-1j * (TWO_PI / sps)) * k).to(CF32)
    c = torch.sum(metric.to(F32) * tone, dim=-1)
    acc = (np.float32(forget) * state_acc + c).to(CF32)
    tau = (-sps / TWO_PI) * torch.angle(acc)
    return acc, torch.remainder(tau, sps)


def phase_unwrap(prev_phase: torch.Tensor, tau: torch.Tensor, sps: int) -> torch.Tensor:
    """Pick the xin-phase == tau+1 (mod sps) nearest the carried phase.

    prev_phase: [...] carried phase, or < 0 on the first block (take the raw
    estimate). Returns phase in [0, 2*sps - 1], valid for
    `timing_sample_phase`.
    """
    raw = torch.remainder(tau + 1.0, sps)
    half = 0.5 * sps
    delta = torch.remainder(raw - prev_phase + half, sps) - half
    phase = torch.where(prev_phase < 0, raw, prev_phase + delta)
    # fold back into the sampler's valid window (a real one-symbol slip)
    phase = torch.where(phase < 0, phase + sps, phase)
    phase = torch.where(phase > 2 * sps - 1, phase - sps, phase)
    return phase.to(F32)


def timing_sample(last: torch.Tensor, x: torch.Tensor, tau: torch.Tensor, sps: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Read one value per symbol at offset tau (mod sps) by linear interpolation.

    Reads index into xin = [last | x], delayed one symbol so interpolation
    never needs future samples. Returns (new_last, symbols [..., N/sps]).
    """
    phase = torch.remainder(tau + 1.0, sps)
    return timing_sample_phase(last, x, phase, sps)


def timing_sample_phase(last: torch.Tensor, x: torch.Tensor, phase: torch.Tensor,
                        sps: int) -> tuple[torch.Tensor, torch.Tensor]:
    """timing_sample with the xin-phase given directly (see phase_unwrap).

    phase: [...] in [0, 2*sps - 1]; positions k*sps + phase stay in
    [0, N + sps - 1] for every k, so i0 + 1 is always in bounds.
    """
    n = x.shape[-1]
    nsym = n // sps
    xin = torch.cat([last, x], dim=-1)  # [..., N + sps + 1]
    t = torch.arange(nsym, dtype=F32, device=x.device) * sps + phase[..., None]
    i0 = torch.floor(t).to(torch.int64)
    frac = t - i0.to(F32)
    shape = (*xin.shape[:-1], nsym)
    lo = torch.gather(xin, -1, torch.broadcast_to(i0, shape))
    hi = torch.gather(xin, -1, torch.broadcast_to(i0 + 1, shape))
    sym = lo * (1.0 - frac) + hi * frac
    return x[..., -(sps + 1):], sym
