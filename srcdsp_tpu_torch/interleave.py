"""Interleavers: block, convolutional (Forney) and fixed-permutation
(counterpart of ``srcdsp_tpu/interleave.py``).

- Block: write an R x C frame by rows, read it by columns (one reshape and
  transpose).
- Convolutional (Forney / Ramsey type II): B branches fed round-robin,
  branch i delaying i*M symbols, each through a CARRIED delay line (a tuple
  of [..., delay_i] tensors); the deinterleaver mirrors with delays
  (B-1-i)*M, and the cascade restores the stream after B(B-1)M symbols.
- Fixed permutation: one index_select per frame with a host-made
  permutation (numpy `default_rng`, the reference's); inverse by argsort.

All forms are dtype-agnostic (bits, soft values, complex symbols).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from srcdsp_tpu_torch.device import resolve

__all__ = [
    "block_interleave", "block_deinterleave",
    "ConvInterleaverState", "conv_interleave_init", "conv_interleave",
    "conv_deinterleave_init", "conv_deinterleave", "conv_total_delay",
    "random_permutation", "permute", "depermute",
]


# ---------- block ----------

def block_interleave(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """[..., K*rows*cols] -> same shape, each frame written by rows and
    read by columns."""
    n = x.shape[-1]
    if n % (rows * cols) != 0:
        raise ValueError(f"length {n} not a multiple of {rows}x{cols}")
    lead = x.shape[:-1]
    f = x.reshape(*lead, n // (rows * cols), rows, cols)
    return f.transpose(-1, -2).reshape(*lead, n)


def block_deinterleave(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    return block_interleave(x, cols, rows)


# ---------- convolutional (Forney) ----------

class ConvInterleaverState(NamedTuple):
    """Per-branch delay lines; branch i holds delay_i symbols, i*M for the
    interleaver and (B-1-i)*M for the deinterleaver: a tuple of
    [..., delay_i] tensors."""

    lines: tuple


def _conv_init(delays: Sequence[int], channel_shape: tuple, dtype, device
               ) -> ConvInterleaverState:
    device = resolve(device)
    return ConvInterleaverState(lines=tuple(
        torch.zeros((*channel_shape, d), dtype=dtype, device=device) for d in delays))


def conv_interleave_init(branches: int, depth: int, channel_shape: tuple = (),
                         dtype=torch.float32, device=None) -> ConvInterleaverState:
    """Zeroed interleaver lines on `device` (the card unless it says otherwise)."""
    return _conv_init([i * depth for i in range(branches)], channel_shape, dtype, device)


def conv_deinterleave_init(branches: int, depth: int, channel_shape: tuple = (),
                           dtype=torch.float32, device=None) -> ConvInterleaverState:
    """Zeroed deinterleaver lines on `device` (the card unless it says otherwise)."""
    return _conv_init([(branches - 1 - i) * depth for i in range(branches)],
                      channel_shape, dtype, device)


def _conv_apply(state: ConvInterleaverState, x: torch.Tensor, branches: int
                ) -> tuple[ConvInterleaverState, torch.Tensor]:
    n = x.shape[-1]
    if n % branches != 0:
        raise ValueError(f"block length {n} not divisible by {branches}")
    lead = x.shape[:-1]
    cols = x.reshape(*lead, n // branches, branches)    # round-robin
    outs, new_lines = [], []
    for i, line in enumerate(state.lines):
        full = torch.cat([line, cols[..., i]], dim=-1)
        outs.append(full[..., : n // branches])
        new_lines.append(full[..., n // branches:])
    y = torch.stack(outs, dim=-1).reshape(*lead, n)
    return ConvInterleaverState(lines=tuple(new_lines)), y


def conv_interleave(state: ConvInterleaverState, x: torch.Tensor
                    ) -> tuple[ConvInterleaverState, torch.Tensor]:
    """One block through the interleaver. x: [..., N], N % B == 0."""
    return _conv_apply(state, x, len(state.lines))


def conv_deinterleave(state: ConvInterleaverState, x: torch.Tensor
                      ) -> tuple[ConvInterleaverState, torch.Tensor]:
    return _conv_apply(state, x, len(state.lines))


def conv_total_delay(branches: int, depth: int) -> int:
    """End-to-end latency of interleave -> deinterleave, in symbols."""
    return branches * (branches - 1) * depth


# ---------- fixed permutation ----------

def random_permutation(n: int, seed: int = 0) -> np.ndarray:
    """Host-side pseudo-random frame permutation (deterministic)."""
    return np.random.default_rng(seed).permutation(n)


def permute(x: torch.Tensor, perm: np.ndarray) -> torch.Tensor:
    """[..., K*len(perm)] frame-wise permutation."""
    n = x.shape[-1]
    p = len(perm)
    if n % p != 0:
        raise ValueError(f"length {n} not a multiple of frame {p}")
    lead = x.shape[:-1]
    f = x.reshape(*lead, n // p, p)
    idx = torch.as_tensor(np.asarray(perm, np.int64), device=x.device)
    return f.index_select(-1, idx).reshape(*lead, n)


def depermute(x: torch.Tensor, perm: np.ndarray) -> torch.Tensor:
    return permute(x, np.argsort(np.asarray(perm)))
