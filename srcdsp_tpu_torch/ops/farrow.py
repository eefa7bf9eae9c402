"""Farrow (cubic-Lagrange) arbitrary-ratio resampler (counterpart of
``srcdsp_tpu/ops/farrow.py``).

For out/in rate L/M the m-th output of a block sits at input time
t_m = (p + m*M)/L with the integer phase p carried in the state, so the
timing is exact integer arithmetic and block joins are bit-exact under any
split. Each block computes every output's 4-sample window index and
fractional mu as int32 tensor ops (floor division and a floor remainder:
p can be negative, and truncating division would pick the wrong window),
gathers the windows [..., capacity, 4] in one indexing, and evaluates the
cubic as (W @ C) . [1, mu, mu^2, mu^3] against the power-basis Lagrange
coefficients. Output counts per block vary by one, so outputs land in a fixed
capacity with a validity mask whose valid lanes are a prefix.

Overflow bound: (n_in + 2) * L < 2^31 per block (int32 phase).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.ops.fir import pin_f32
from srcdsp_tpu_torch.types import CF32, F32

__all__ = [
    "FarrowState", "farrow_init", "farrow_apply", "farrow_capacity",
    "make_farrow_ratio", "np_farrow", "LAGRANGE_C",
]

# Lagrange basis at support points {-1, 0, 1, 2} expanded in powers of mu:
# l_i(mu) = sum_p C[i, p] mu^p ; y(mu) = sum_i x[n+i-1] l_i(mu)
LAGRANGE_C = np.array([
    [0.0, -1.0 / 3.0, 1.0 / 2.0, -1.0 / 6.0],
    [1.0, -1.0 / 2.0, -1.0, 1.0 / 2.0],
    [0.0, 1.0, 1.0 / 2.0, -1.0 / 2.0],
    [0.0, -1.0 / 6.0, 0.0, 1.0 / 6.0],
], dtype=np.float64)


class FarrowState(NamedTuple):
    """tail: last 3 input samples; p: integer phase numerator, the next
    output's input time is p/L samples into the coming block (may be
    negative: the point can sit inside the tail)."""

    tail: torch.Tensor   # [..., 3]
    p: torch.Tensor      # [] int32


def make_farrow_ratio(out_rate: int, in_rate: int) -> tuple[int, int]:
    """(L, M) reduced: consume M input samples per L output samples."""
    g = math.gcd(int(out_rate), int(in_rate))
    return int(out_rate) // g, int(in_rate) // g


def farrow_capacity(n_in: int, l_out: int, m_in: int) -> int:
    """Static per-block output capacity: ceil(n_in * L / M) + 1."""
    return -(-n_in * l_out // m_in) + 1


def farrow_init(channel_shape: tuple = (), dtype=CF32, device=None) -> FarrowState:
    device = resolve(device)
    return FarrowState(tail=torch.zeros((*channel_shape, 3), dtype=dtype, device=device),
                       p=torch.zeros((), dtype=torch.int32, device=device))


def farrow_apply(state: FarrowState, x: torch.Tensor, l_out: int, m_in: int
                 ) -> tuple[FarrowState, tuple[torch.Tensor, torch.Tensor]]:
    """Resample one block by L/M (outputs per inputs). x: [..., N] ->
    (y [..., capacity], valid [capacity] bool). Valid outputs are a prefix of
    y; invalid lanes hold garbage. N * L must stay below 2^31."""
    pin_f32(x)
    n = x.shape[-1]
    cap = farrow_capacity(n, l_out, m_in)
    dev = x.device
    xin = torch.cat([state.tail, x], dim=-1)                         # [..., N+3]
    t_num = state.p + torch.arange(cap, dtype=torch.int32, device=dev) * m_in
    base = torch.div(t_num, l_out, rounding_mode="floor")            # n_m (x coords)
    mu = torch.remainder(t_num, l_out).to(F32) / np.float32(l_out)
    valid = base <= n - 3
    # window x[n-1 .. n+2] -> xin[n+2 .. n+5]
    idx = base[:, None] + torch.arange(-1, 3, dtype=torch.int32, device=dev)[None, :] + 3
    w = xin[..., idx.clamp(0, n + 2).long()]                         # [..., cap, 4]
    c = torch.as_tensor(LAGRANGE_C, dtype=F32, device=dev)
    pw = torch.stack([torch.ones_like(mu), mu, mu * mu, mu * mu * mu], dim=-1)   # [cap, 4]
    if xin.is_complex():
        branches = torch.complex(w.real @ c, w.imag @ c)
    else:
        branches = w @ c
    y = torch.sum(branches * pw, dim=-1).to(xin.dtype)
    n_out = valid.to(torch.int32).sum(dtype=torch.int32)
    new_p = state.p + n_out * m_in - n * l_out
    return FarrowState(tail=xin[..., xin.shape[-1] - 3:], p=new_p), (y, valid)


def np_farrow(x: np.ndarray, l_out: int, m_in: int) -> np.ndarray:
    """Per-output sequential twin (double precision, zero initial tail)."""
    x = np.concatenate([np.zeros(3, x.dtype), np.asarray(x)])
    n = x.shape[-1] - 3
    out = []
    p, m = 0, 0
    while True:
        t = p + m * m_in
        base = t // l_out
        if base > n - 3:
            break
        mu = (t % l_out) / l_out
        w = x[base + 2: base + 6].astype(np.complex128)
        pw = np.array([1.0, mu, mu ** 2, mu ** 3])
        out.append(np.dot(w, LAGRANGE_C @ pw))
        m += 1
    return np.asarray(out)
