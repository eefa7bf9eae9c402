"""Automatic gain control (counterpart of ``srcdsp_tpu/ops/agc.py``).

A feedforward envelope normalizer with the steady-state behavior of the
classic feedback AGC: a one-pole IIR lowpass tracks the instantaneous power,
and the output is scaled by target/sqrt(envelope). The smoother is linear,
so it runs on the exact block state-space machinery of ``ops.iir``; its state
is the only thing carried between blocks. Time constant ~ 1/(1-alpha)
samples.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from srcdsp_tpu_torch.ops.iir import IirParams, IirState, iir_apply, iir_init, make_iir_params
from srcdsp_tpu_torch.types import F32

__all__ = ["AgcParams", "AgcState", "make_agc_params", "agc_init", "agc_apply", "agc_full"]


class AgcParams(NamedTuple):
    smoother: IirParams   # one-pole power lowpass
    target: float         # desired RMS amplitude
    floor: float          # power floor (no gain blow-up on silence)


class AgcState(NamedTuple):
    env: IirState


def make_agc_params(alpha: float = 0.99, target: float = 1.0, floor: float = 1e-6,
                    block: int = 128, device=None) -> AgcParams:
    """One-pole envelope smoother y[n] = (1-alpha) p[n] + alpha y[n-1]."""
    if not 0.0 < alpha < 1.0:
        raise ValueError(f"alpha must be in (0, 1), got {alpha}")
    smoother = make_iir_params(np.array([1.0 - alpha]), np.array([1.0, -alpha]),
                               block=block, device=device)
    return AgcParams(smoother=smoother, target=float(target), floor=float(floor))


def agc_init(params: AgcParams, channel_shape: tuple = (), device=None) -> AgcState:
    return AgcState(env=iir_init(params.smoother, channel_shape, dtype=F32, device=device))


def agc_apply(params: AgcParams, state: AgcState, x: torch.Tensor
              ) -> tuple[AgcState, torch.Tensor]:
    """Normalize one block. x: [..., N] complex, N % smoother block == 0."""
    p = (x.real ** 2 + x.imag ** 2).to(F32)
    env_s, env = iir_apply(params.smoother, state.env, p)
    gain = params.target * torch.rsqrt(torch.clamp(env, min=params.floor))
    return AgcState(env=env_s), x * gain.to(x.dtype)


def agc_full(params: AgcParams, x: torch.Tensor) -> torch.Tensor:
    """Whole-signal convenience (from rest)."""
    return agc_apply(params, agc_init(params, tuple(x.shape[:-1]), device=x.device), x)[1]
