"""CIC (cascaded integrator-comb) decimator / interpolator (counterpart of
``srcdsp_tpu/ops/cic.py``).

- N integrator stages, each a prefix sum over the block plus a carried
  accumulator per stage, which reproduces the per-sample recurrence exactly.
- Decimate by R: the last integrator output of each group of R.
- N comb stages at the low rate: y[m] - y[m-M] with an M-sample carried tail.

In int32 every sum wraps mod 2^32 (two's complement), the hardware CIC's
modular arithmetic, so bit growth past 2^31 never corrupts the output. torch
gives an int32 ``cumsum`` an int64 result, so the int path sums in int64 and
wraps each result back to int32 explicitly (`_wrap`): the same ring, the same
bits as the JAX package's int32 ``cumsum``. Float states sum in their own
dtype. DC gain is (R*M)^N; the interpolator is the transpose (combs at the low
rate, zero-stuff by R, integrators at the high rate). `cic_compensator` and
`np_cic_decim` are host numpy copies.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from srcdsp_tpu_torch.device import resolve

__all__ = [
    "CicState", "cic_decim_init", "cic_decim_apply", "cic_gain",
    "cic_interp_init", "cic_interp_apply", "cic_compensator", "np_cic_decim",
]

_SIGN = 1 << 31


class CicState(NamedTuple):
    """integ: [..., N] per-stage accumulators (entry values for the next
    block); combs: [..., N, M] per-stage delay lines at the comb rate."""

    integ: torch.Tensor
    combs: torch.Tensor


def cic_gain(rate: int, order: int, delay: int = 1) -> int:
    """DC gain (R*M)^N: divide by this to normalize."""
    return (rate * delay) ** order


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The dtype an integer path sums in before `_wrap` (int64 for int32)."""
    return torch.int64 if dtype == torch.int32 else dtype


def _wrap(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An integer result as int32 with two's-complement wrap (mod 2^32);
    other dtypes pass through."""
    if dtype != torch.int32:
        return v
    return (((v.to(torch.int64) & 0xFFFFFFFF) ^ _SIGN) - _SIGN).to(torch.int32)


def _integrators(x: torch.Tensor, carry: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """N cascaded running sums over the last axis. carry: [..., N] entry
    accumulators; returns (y, new_carry)."""
    dt = carry.dtype
    y = x
    outs = []
    for i in range(carry.shape[-1]):
        y = _wrap(torch.cumsum(y, dim=-1, dtype=_acc(dt)) + carry[..., i:i + 1], dt)
        outs.append(y[..., -1:])
    return y, torch.cat(outs, dim=-1)


def _combs(y: torch.Tensor, tails: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """N cascaded y[m] - y[m-M] stages. tails: [..., N, M] carried history;
    returns (out, new_tails)."""
    n, m = tails.shape[-2], tails.shape[-1]
    new_tails = []
    for i in range(n):
        full = torch.cat([tails[..., i, :], y], dim=-1)
        new_tails.append(full[..., full.shape[-1] - m:][..., None, :])
        y = _wrap(full[..., m:].to(_acc(tails.dtype)) - full[..., :-m], tails.dtype)
    return y, torch.cat(new_tails, dim=-2)


def cic_decim_init(order: int, delay: int = 1, channel_shape: tuple = (),
                   dtype=torch.int32, device=None) -> CicState:
    device = resolve(device)
    return CicState(integ=torch.zeros((*channel_shape, order), dtype=dtype, device=device),
                    combs=torch.zeros((*channel_shape, order, delay), dtype=dtype,
                                      device=device))


def cic_decim_apply(state: CicState, x: torch.Tensor, rate: int
                    ) -> tuple[CicState, torch.Tensor]:
    """x: [..., B] with B % rate == 0 -> y: [..., B/rate].

    Concatenated block outputs equal the one-shot run (bit-exact in int32).
    The output is not gain-normalized: scale by 1/cic_gain(...) downstream.
    """
    b = x.shape[-1]
    if b % rate != 0:
        raise ValueError(f"block length {b} not divisible by rate {rate}")
    y, integ = _integrators(x.to(state.integ.dtype), state.integ)
    # phase convention: the LAST integrator output of each group
    y = y[..., rate - 1::rate]
    y, combs = _combs(y, state.combs)
    return CicState(integ=integ, combs=combs), y


def cic_interp_init(order: int, delay: int = 1, channel_shape: tuple = (),
                    dtype=torch.int32, device=None) -> CicState:
    return cic_decim_init(order, delay, channel_shape, dtype, device)


def cic_interp_apply(state: CicState, x: torch.Tensor, rate: int
                     ) -> tuple[CicState, torch.Tensor]:
    """x: [..., B] -> y: [..., B*rate] (combs at the low rate, zero-stuff,
    integrators at the high rate)."""
    y, combs = _combs(x.to(state.integ.dtype), state.combs)
    up = torch.zeros((*y.shape, rate), dtype=y.dtype, device=y.device)
    up[..., 0] = y
    out, integ = _integrators(up.reshape(*y.shape[:-1], y.shape[-1] * rate), state.integ)
    return CicState(integ=integ, combs=combs), out


def cic_compensator(num_taps: int, rate: int, order: int, delay: int = 1,
                    cutoff: float = 0.25) -> np.ndarray:
    """Inverse-sinc^N compensation FIR for the decimated rate (host numpy).

    Frequency-sampled least-squares design: target |H| = 1/droop up to
    `cutoff` (cycles/sample at the LOW rate), don't-care to 1.25*cutoff, 0
    beyond; symmetric taps normalized to unit DC gain.
    """
    if num_taps % 2 == 0:
        raise ValueError("num_taps must be odd (type-I linear phase)")
    ngrid = 16 * num_taps
    f = np.linspace(0.0, 0.5, ngrid)
    # CIC droop at the low rate: sin(pi f M) / (RM sin(pi f / R)) per stage
    arg_n = np.pi * f * delay
    arg_d = np.pi * f / rate
    with np.errstate(invalid="ignore", divide="ignore"):
        droop = np.where(
            f == 0.0, 1.0,
            (np.sin(arg_n) / (rate * delay * np.sin(arg_d))) ** order)
    target = np.where(f <= cutoff, 1.0 / np.abs(droop), 0.0)
    w = np.where(f <= cutoff, 10.0, np.where(f <= 1.25 * cutoff, 0.0, 1.0))
    half = (num_taps - 1) // 2
    m = np.arange(1, half + 1)
    basis = np.concatenate(
        [np.ones((ngrid, 1)), 2.0 * np.cos(2 * np.pi * np.outer(f, m))],
        axis=1)                                  # [ngrid, half+1]
    sw = np.sqrt(w)[:, None]
    a, *_ = np.linalg.lstsq(basis * sw, target * sw[:, 0], rcond=None)
    taps = np.concatenate([a[::-1][:half], a])   # symmetric, length T
    taps /= taps.sum()
    return taps.astype(np.float32)


def np_cic_decim(x: np.ndarray, rate: int, order: int, delay: int = 1,
                 dtype=np.int32) -> np.ndarray:
    """Sequential twin (hardware-style) for tests; int32 wraps like the
    block form."""
    x = np.asarray(x, dtype)
    with np.errstate(over="ignore"):
        y = x
        for _ in range(order):
            y = np.cumsum(y, axis=-1, dtype=dtype)
        y = y[..., rate - 1::rate]
        m = delay
        for _ in range(order):
            pad = np.concatenate(
                [np.zeros((*y.shape[:-1], m), dtype), y], axis=-1)
            y = pad[..., m:] - pad[..., :-m]
    return y
