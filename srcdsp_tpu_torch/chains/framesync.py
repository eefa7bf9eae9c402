"""Preamble correlation / burst detection (counterpart of
``srcdsp_tpu/chains/framesync.py``).

Finds known-preamble bursts in a sample stream: normalized matched-filter
correlation + local-max peak detection.

- the matched filter is ``ops.fir`` with complex taps conj(p[::-1]),
  streaming state carried like every FIR;
- the normalizer is a second FIR (moving energy over the same T-sample
  window), so score[n] = |corr[n]| / (||p|| sqrt(E[n])) is a normalized
  correlation in [0, 1] regardless of input level;
- peak decisions are a 3-tap comparison emitted as a mask over static
  shapes; the host compacts mask -> global sample indices (`peak_indices`).

Seam correctness: each block defers its last score and decides it first
thing next block, so the decisions for a block of N samples cover global
scores [g0-1, g0+N-1) and no peak is missed or doubled at a seam.

Index convention: a preamble whose first sample sits at global input index s
peaks at score index s + T - 1; `peak_to_burst_start` undoes it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.ops.fir import FirState, fir_apply, fir_init
from srcdsp_tpu_torch.types import F32

__all__ = ["FrameSyncParams", "FrameSyncState", "make_frame_sync_params", "frame_sync_init",
           "frame_sync_apply", "peak_indices", "peak_to_burst_start"]


class FrameSyncParams(NamedTuple):
    mf_taps: torch.Tensor   # [T] complex64: conj(preamble[::-1])
    en_taps: torch.Tensor   # [T] float32 ones (moving energy window)
    pnorm: float            # ||preamble||_2
    threshold: float        # normalized-score threshold in (0, 1)


class FrameSyncState(NamedTuple):
    corr: FirState
    energy: FirState
    prev2: torch.Tensor     # [..., 2] carried scores (seam-correct peaks)
    base: torch.Tensor      # [] int32: global score index of block start


def make_frame_sync_params(preamble, threshold: float = 0.6, device=None) -> FrameSyncParams:
    """Params for a 1-D preamble; the taps live on `device` (None = the card)."""
    p = np.asarray(preamble, np.complex64)
    if p.ndim != 1:
        raise ValueError(f"preamble must be 1-D, got {p.shape}")
    device = resolve(device)
    return FrameSyncParams(
        mf_taps=torch.as_tensor(np.conj(p[::-1]).copy(), device=device),
        en_taps=torch.ones(p.shape[0], dtype=F32, device=device),
        pnorm=float(np.sqrt(np.sum(np.abs(p) ** 2))),
        threshold=float(threshold))


def frame_sync_init(params: FrameSyncParams, channel_shape: tuple = ()) -> FrameSyncState:
    """Zero state on the params' device."""
    t = int(params.mf_taps.shape[0])
    dev = params.mf_taps.device
    return FrameSyncState(corr=fir_init(t, channel_shape, device=dev),
                          energy=fir_init(t, channel_shape, dtype=F32, device=dev),
                          prev2=torch.zeros((*channel_shape, 2), dtype=F32, device=dev),
                          base=torch.zeros((), dtype=torch.int32, device=dev))


def frame_sync_apply(params: FrameSyncParams, state: FrameSyncState, x: torch.Tensor
                     ) -> tuple[FrameSyncState, tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Score one block. x: [..., N] complex.

    Returns (state, (score, mask, first_idx)): decisions for the N global
    score positions [base-1, base+N-1); score[i] is the normalized
    correlation at global index first_idx + i and mask[i] is True where it
    is an over-threshold local maximum (strictly above the left neighbour,
    at least the right one). The first block's leading decision (global
    index -1) is always False.
    """
    n = x.shape[-1]
    corr_s, c = fir_apply(params.mf_taps, state.corr, x)
    p2 = (x.real ** 2 + x.imag ** 2).to(F32)
    en_s, e = fir_apply(params.en_taps, state.energy, p2)
    e = e.real.to(F32)
    score = torch.abs(c).to(F32) / (params.pnorm * torch.sqrt(torch.clamp(e, min=0.0))
                                    + np.float32(1e-12))
    ext = torch.cat([state.prev2, score], dim=-1)         # [..., N+2]
    mid = ext[..., 1:n + 1]
    mask = (mid > params.threshold) & (mid > ext[..., 0:n]) & (mid >= ext[..., 2:n + 2])
    first_idx = state.base - 1
    return FrameSyncState(corr=corr_s, energy=en_s,
                          prev2=ext[..., n:n + 2], base=state.base + n), (mid, mask, first_idx)


def peak_indices(masks, first_idxs) -> np.ndarray:
    """Host-side sink: global score indices of detected peaks. masks: list of
    [N] bool blocks (one channel); first_idxs: each block's first_idx."""
    out = []
    for m, f in zip(masks, first_idxs):
        w = np.nonzero(np.asarray(torch.as_tensor(m).cpu()))[0]
        out.extend((int(f) + w).tolist())
    return np.asarray(out, np.int64)


def peak_to_burst_start(peak_idx, num_taps: int):
    """Global input index of the preamble's first sample for a peak."""
    return peak_idx - (num_taps - 1)
