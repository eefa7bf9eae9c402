"""Half-band FIR decimators and decimate-by-2^k cascades (counterpart of
``srcdsp_tpu/ops/halfband.py``).

A half-band lowpass (cutoff 0.25 cycles/sample) has every even-offset tap
zero except the center, so its decimate-by-2 polyphase split is

    y[m] = (h_odd * x_even)[m] + c * x_odd[m - D]

one dense FIR over the even-sample stream (all the nonzero off-center taps,
``ops.fir``) plus a scaled, delayed copy of the odd-sample stream. Streaming
state is the even-stream FIR tail plus a (D+1)-sample odd-stream delay carry.
`design_halfband` runs on the host and returns float64 taps, as the JAX one
does; the dense taps enter the filter as float32, where the JAX package's
``jnp.asarray`` lands them.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from srcdsp_tpu_torch.ops.fir import FirState, fir_apply, fir_init
from srcdsp_tpu_torch.ops.window import _kaiser_beta, kaiser
from srcdsp_tpu_torch.types import CF32

__all__ = [
    "design_halfband", "HalfbandState", "halfband_init", "halfband_decim",
    "HalfbandCascade", "cascade_init", "cascade_apply", "np_halfband_decim",
]


def design_halfband(num_taps: int, atten_db: float = 70.0) -> np.ndarray:
    """Kaiser-windowed half-band lowpass. num_taps must be 3 (mod 4) (odd
    length, odd center index, center-adjacent taps nonzero). Taps at odd
    offsets from the center are the nonzeros; the others (but the center) are
    exactly zero."""
    if num_taps % 4 != 3:
        raise ValueError(f"half-band length must be 4k+3, got {num_taps}")
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = np.sinc(n / 2.0) / 2.0                 # ideal cutoff 0.25
    h *= kaiser(num_taps, _kaiser_beta(atten_db))
    # enforce the exact half-band structure (the window leaves ~1e-17 dust)
    c = (num_taps - 1) // 2
    mask = np.zeros(num_taps, bool)
    mask[1 - c % 2::2] = True                  # odd offsets from center
    mask[c] = True
    h = np.where(mask, h, 0.0)
    # center tap exactly 0.5 and the off-center taps summing to 0.5 (DC gain 1)
    h[c] = 0.0
    h *= 0.5 / h.sum()
    h[c] = 0.5
    return h.astype(np.float64)


class HalfbandState(NamedTuple):
    even: FirState         # dense FIR tail on the even-sample stream
    odd: torch.Tensor      # [..., D+1] carried odd-sample delay line


def _split_taps(h: np.ndarray) -> tuple[np.ndarray, float, int]:
    """h (4k+3 half-band) -> (dense float32 taps on the even stream, center
    coefficient, odd-stream delay D in half-rate samples)."""
    h = np.asarray(h, np.float64)
    c = (len(h) - 1) // 2
    # the center index c = 2k+1 is odd, so the off-center nonzeros sit at even
    # absolute indices: a causal FIR on the even-sample stream; the center
    # term is x_odd delayed by (c+1)/2 half-rate samples
    return h[0::2].astype(np.float32), float(h[c]), (c - 1) // 2


def halfband_init(h: np.ndarray, channel_shape: tuple = (), dtype=CF32,
                  device=None) -> HalfbandState:
    dense, _, d = _split_taps(h)
    even = fir_init(len(dense), channel_shape, dtype=dtype, device=device)
    return HalfbandState(even=even, odd=torch.zeros((*channel_shape, d + 1), dtype=dtype,
                                                    device=even.tail.device))


def halfband_decim(h: np.ndarray, state: HalfbandState, x: torch.Tensor
                   ) -> tuple[HalfbandState, torch.Tensor]:
    """Decimate by 2 with the polyphase half-band split.

    x: [..., N], N even -> y: [..., N/2]. Block splits concatenate to the
    one-shot output (the carried state is exact)."""
    dense, center, d = _split_taps(h)
    n = x.shape[-1]
    if n % 2 != 0:
        raise ValueError(f"block length {n} must be even")
    ev_state, y_even = fir_apply(dense, state.even, x[..., 0::2])
    odd_full = torch.cat([state.odd, x[..., 1::2]], dim=-1)
    y_odd = odd_full[..., : n // 2]            # = x_odd[m - (d+1)]
    new_state = HalfbandState(even=ev_state, odd=odd_full[..., odd_full.shape[-1] - (d + 1):])
    return new_state, (y_even + y_odd * np.float32(center)).to(x.dtype)


class HalfbandCascade(NamedTuple):
    taps: tuple        # per-stage designs (np arrays)


def cascade_init(stages: Sequence[np.ndarray], channel_shape: tuple = (), dtype=CF32,
                 device=None) -> tuple[HalfbandState, ...]:
    return tuple(halfband_init(h, channel_shape, dtype, device) for h in stages)


def cascade_apply(stages: Sequence[np.ndarray], states: Sequence[HalfbandState],
                  x: torch.Tensor) -> tuple[tuple[HalfbandState, ...], torch.Tensor]:
    """Decimate by 2^len(stages), each half-band at half the previous rate.
    Block length must divide by 2^k."""
    new_states = []
    y = x
    for h, st in zip(stages, states):
        st2, y = halfband_decim(h, st, y)
        new_states.append(st2)
    return tuple(new_states), y


def np_halfband_decim(h: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Reference: full-rate causal FIR, then every 2nd output (phase 0)."""
    t = len(h)
    xin = np.concatenate([np.zeros(t - 1, x.dtype), x])
    full = np.convolve(xin, h, mode="valid")
    return full[0::2]
