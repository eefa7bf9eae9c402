"""Rational L/M resampler (counterpart of ``srcdsp_tpu/ops/resample.py``).

Semantics (the reference's, mirrored by the C++ oracle): with u the
zero-stuffed upsample of x (u[i*L] = x[i], else 0) and causal filtering from
rest,

    y[j] = sum_k h[k] u[j*M - k] = sum_i h[j*M - i*L] x[i]

Output rate is fs*L/M. Streaming: taps are zero-padded to T' with
(T'-1) % L == 0, so the carried tail is exactly (T'-1)/L input samples, and
every block needs N*L % M == 0, which keeps block boundaries on exact output
samples.

The plain form is polyphase, not a dilated convolution: output j reads the
taps of one phase, phi = j*M mod L,

    y[j] = sum_q h[phi + q*L] * x[floor(j*M/L) - q],

and the sum runs over q in ascending order as separate multiplies and adds
on strided slices, one slice per (output phase, tap). Each output's
arithmetic is the same wherever the block boundary falls, so block joins are
bit-exact on any device (a cuDNN convolution picks its algorithm by shape,
which would not keep them so), and no zero-stuffed sample is ever stored.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.types import CF32


class ResampleState(NamedTuple):
    """Carried input-domain tail: last (T'-1)/L input samples."""

    tail: torch.Tensor  # [..., (T'-1)/L] complex64


def _padded_len(num_taps: int, up: int) -> int:
    """Smallest T' >= num_taps with (T'-1) % up == 0."""
    return num_taps + (-(num_taps - 1)) % up


def pad_taps(taps, up: int) -> torch.Tensor:
    taps = torch.as_tensor(taps)
    return F.pad(taps, (0, _padded_len(taps.shape[0], up) - taps.shape[0]))


def resample_init(num_taps: int, up: int, channel_shape: tuple = (), dtype=CF32,
                  device=None) -> ResampleState:
    ntail = (_padded_len(num_taps, up) - 1) // up
    return ResampleState(tail=torch.zeros((*channel_shape, ntail), dtype=dtype,
                                          device=resolve(device)))


def polyphase_resample(v: torch.Tensor, taps, up: int, down: int, hist: int
                       ) -> torch.Tensor:
    """Plain L/M resampler over the last axis of a real tensor.

    v: [..., hist + N] float32, the first `hist` samples history (at least
    ceil(T/up) - 1 of them). Returns y [..., N*up/down] with
    y[j] = sum_i h[j*down - i*up] v[hist + i], each output summed in a fixed
    order (see the module docstring).
    """
    h = np.asarray(taps.cpu() if isinstance(taps, torch.Tensor) else taps, np.float32)
    t = h.shape[0]
    n = v.shape[-1] - hist
    if (n * up) % down != 0:
        raise ValueError(f"N*L={n}*{up} not divisible by M={down}")
    if hist < -(-t // up) - 1:
        raise ValueError(f"history {hist} < ceil(T/L) - 1 for T={t}, L={up}")
    nout = n * up // down
    period = up // math.gcd(up, down)     # outputs j and j + period share a phase
    hop = down // math.gcd(up, down)      # ... and their inputs lie hop apart
    y = v.new_empty((*v.shape[:-1], nout))
    for r in range(min(period, nout)):
        count = (nout - 1 - r) // period + 1
        phi, base = (r * down) % up, hist + (r * down) // up
        acc = None
        for k in range(phi, t, up):       # q = (k - phi) / up, ascending
            start = base - (k - phi) // up
            term = v[..., start:start + (count - 1) * hop + 1:hop] * float(h[k])
            acc = term if acc is None else acc + term
        y[..., r::period] = acc
    return y


def resample_apply(taps, state: ResampleState, x: torch.Tensor, up: int, down: int
                   ) -> tuple[ResampleState, torch.Tensor]:
    """Resample one block. x: [..., N] complex, N*up % down == 0 ->
    y: [..., N*up//down] complex64.

    `taps` may be the original (unpadded) design; the tail length follows the
    padded T' as in the reference.
    """
    n = x.shape[-1]
    if (n * up) % down != 0:
        raise ValueError(f"N*L={n}*{up} not divisible by M={down}")
    num_taps = len(taps)
    ntail = (_padded_len(num_taps, up) - 1) // up
    if state.tail.shape[-1] != ntail:
        raise ValueError(f"state tail {state.tail.shape[-1]} != expected {ntail}")
    xin = torch.cat([state.tail, x.to(state.tail.dtype)], dim=-1)
    planes = torch.view_as_real(xin).movedim(-1, -2)         # [..., 2, ntail + N]
    y = polyphase_resample(planes, taps, up, down, ntail)
    # xin = [tail, x] always holds at least ntail samples
    return ResampleState(tail=xin[..., xin.shape[-1] - ntail:]), torch.complex(y[..., 0, :],
                                                                               y[..., 1, :])


def resample_full(taps, x: torch.Tensor, up: int, down: int) -> torch.Tensor:
    """Whole-signal resample from rest (one-shot convenience)."""
    state = resample_init(len(taps), up, channel_shape=tuple(x.shape[:-1]), dtype=CF32,
                          device=x.device)
    _, y = resample_apply(taps, state, x, up, down)
    return y
