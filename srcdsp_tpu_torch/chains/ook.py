"""Noncoherent OOK/ASK demodulation (counterpart of ``srcdsp_tpu/chains/ook.py``).

On-off keying (garage remotes, tire sensors, most sub-GHz ISM links), with
no per-sample loop:

- **Envelope**: |x| (noncoherent: carrier phase and small CFO drop out).
- **Matched filter**: the sps-sample boxcar (integrate-and-dump's linear
  form) as one cumsum difference with a carried (sps-1) tail.
- **Symbol timing**: ``chains.sync``'s O&M square-law estimator on the
  squared matched-filter output, with the strobe phase carried across blocks
  (``phase_unwrap``) so jitter over the mod-sps wrap never slips a symbol.
- **Threshold**: two-means slicing: carried, exponentially forgotten
  {low, high} cluster sums updated from each block's strobes (one Lloyd
  pass from the block midpoint; masked sums, static shapes).

Manchester decoding (IEEE convention, 10 -> 1) with blind half-bit
alignment is provided for protocols that line-code.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from srcdsp_tpu_torch.chains.sync import (TimingState, phase_unwrap, timing_estimate,
                                          timing_init, timing_sample_phase)
from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.types import F32

__all__ = ["OokParams", "OokState", "make_ook_params", "ook_init", "ook_apply",
           "ook_demod_full", "manchester_decode"]


class OokParams(NamedTuple):
    sps: int               # samples per bit (per half-bit if Manchester)
    timing_forget: float   # O&M accumulator memory
    level_forget: float    # threshold cluster-sum memory


class OokState(NamedTuple):
    mf_tail: torch.Tensor  # [..., sps-1] envelope tail for the boxcar
    timing: TimingState
    phase: torch.Tensor    # [...] carried strobe phase (< 0 = first block)
    lo_sum: torch.Tensor   # [...] forgotten sum of low-cluster strobes
    lo_n: torch.Tensor     # [...] forgotten low-cluster count
    hi_sum: torch.Tensor
    hi_n: torch.Tensor


def make_ook_params(sps: int, timing_forget: float = 0.5,
                    level_forget: float = 0.9) -> OokParams:
    if sps < 2:
        raise ValueError(f"sps must be >= 2, got {sps}")
    if not 0.0 <= timing_forget < 1.0 or not 0.0 <= level_forget < 1.0:
        raise ValueError("forget factors must be in [0, 1)")
    return OokParams(sps=int(sps), timing_forget=float(timing_forget),
                     level_forget=float(level_forget))


def ook_init(params: OokParams, channel_shape: tuple = (), device=None) -> OokState:
    device = resolve(device)
    z = torch.zeros(channel_shape, dtype=F32, device=device)
    return OokState(
        mf_tail=torch.zeros((*channel_shape, params.sps - 1), dtype=F32, device=device),
        timing=timing_init(params.sps, channel_shape, dtype=F32, device=device),
        phase=torch.full(channel_shape, -1.0, dtype=F32, device=device),
        lo_sum=z, lo_n=z, hi_sum=z, hi_n=z)


def _boxcar(tail: torch.Tensor, env: torch.Tensor, sps: int
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Moving sum of the last sps samples (streaming): one cumsum over
    [tail | env] differenced at lag sps. Returns (new_tail, mf [..., N])."""
    ext = torch.cat([tail, env], dim=-1)                  # [..., N + sps - 1]
    c = torch.cumsum(ext.to(F32), dim=-1)
    n = env.shape[-1]
    hi = c[..., sps - 1: sps - 1 + n]
    lo = torch.cat([torch.zeros_like(c[..., :1]), c[..., :n - 1]], dim=-1)
    return ext[..., ext.shape[-1] - (sps - 1):], hi - lo


def ook_apply(params: OokParams, state: OokState, x: torch.Tensor
              ) -> tuple[OokState, tuple[torch.Tensor, torch.Tensor]]:
    """Demodulate one block. x: [..., N] complex, N % sps == 0.

    Returns (state, (bits [..., N/sps] int32, strobes [..., N/sps] float32)):
    the strobes are the matched-filter symbol samples, the bits the
    thresholded decisions.
    """
    sps = params.sps
    env = torch.abs(x.to(torch.complex64)).to(F32)
    tail, mf = _boxcar(state.mf_tail, env, sps)
    acc, tau = timing_estimate(state.timing.acc, mf * mf, sps, forget=params.timing_forget)
    # unwrap toward the carried phase: the strobe grid stays continuous
    phase = phase_unwrap(state.phase, tau, sps)
    last, strobes = timing_sample_phase(state.timing.last, mf, phase, sps)
    # two-means threshold: seed at the block midpoint, one Lloyd pass on this
    # block, then blend into the carried cluster sums
    mid = 0.5 * (torch.amax(strobes, dim=-1) + torch.amin(strobes, dim=-1))
    hi_m = strobes > mid[..., None]
    zero = torch.zeros((), dtype=F32, device=x.device)
    blk_hi = torch.sum(torch.where(hi_m, strobes, zero), dim=-1)
    blk_hi_n = torch.sum(hi_m.to(F32), dim=-1)
    blk_lo = torch.sum(torch.where(hi_m, zero, strobes), dim=-1)
    blk_lo_n = torch.sum((~hi_m).to(F32), dim=-1)
    g = float(np.float32(params.level_forget))
    lo_sum = g * state.lo_sum + blk_lo
    lo_n = g * state.lo_n + blk_lo_n
    hi_sum = g * state.hi_sum + blk_hi
    hi_n = g * state.hi_n + blk_hi_n
    thr = 0.5 * (lo_sum / torch.clamp(lo_n, min=1.0) + hi_sum / torch.clamp(hi_n, min=1.0))
    bits = (strobes > thr[..., None]).to(torch.int32)
    st = OokState(mf_tail=tail, timing=TimingState(acc=acc, last=last), phase=phase,
                  lo_sum=lo_sum, lo_n=lo_n, hi_sum=hi_sum, hi_n=hi_n)
    return st, (bits, strobes)


def ook_demod_full(params: OokParams, x: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Whole-signal convenience (from rest), on x's device."""
    _, out = ook_apply(params, ook_init(params, tuple(x.shape[:-1]), device=x.device), x)
    return out


def manchester_decode(chips: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode IEEE-802.3 Manchester half-bit chips (10 -> 1, 01 -> 0) with
    blind alignment: of the two pairings, pick the one with more valid
    (unequal) chip pairs. chips: [..., L] int. Returns (bits [..., L//2]
    int32, valid_fraction [...] float32). The offset-1 candidate decodes
    (L-1)//2 pairs, zero-padded to L//2; validity is compared over each
    candidate's own complete pairs.
    """
    chips = torch.as_tensor(chips).to(torch.int32)
    length = chips.shape[-1]
    nbit = length // 2
    if length < 3:
        raise ValueError("need at least 3 chips for blind alignment")

    def pair(off):
        avail = (length - off) // 2
        c = chips[..., off: off + 2 * avail]
        c = c.reshape(*c.shape[:-1], avail, 2)
        bits = c[..., 0]
        valid = torch.mean((c[..., 0] != c[..., 1]).to(F32), dim=-1)
        if avail < nbit:
            bits = torch.cat([bits, torch.zeros((*bits.shape[:-1], nbit - avail),
                                                dtype=bits.dtype, device=bits.device)], dim=-1)
        return bits, valid

    b0, v0 = pair(0)
    b1, v1 = pair(1)
    use1 = v1 > v0
    bits = torch.where(use1[..., None], b1, b0)
    return bits.to(torch.int32), torch.where(use1, v1, v0)
