"""Frequency-hopping spread spectrum: hop, acquire, dehop (counterpart of
``srcdsp_tpu/chains/fhss.py``).

- **Hop/dehop** are one reshape + one broadcast multiply: the stream is
  viewed as [K, L] hop segments and each row gets its hop tone. The tones
  are built on the host in float64 from the hop table (each hop restarts at
  phase 0) and cast to complex64, where the reference lands them.
- **Acquisition** (hop timing + sequence phase, no data aided): each
  candidate segment's energy at every hop frequency is one [K, L] x [L, H]
  product on the stream's device per coarse timing candidate; the
  per-segment argmax classes come back to the host, where the circular
  match against the known hop pattern runs, as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from srcdsp_tpu_torch.device import as_tensor_on
from srcdsp_tpu_torch.ops.fir import pin_f32
from srcdsp_tpu_torch.types import CF32

__all__ = ["FhssParams", "make_fhss_params", "fhss_hop", "fhss_dehop", "fhss_acquire"]


class FhssParams(NamedTuple):
    freqs: np.ndarray      # [H] hop frequencies, cycles/sample (host)
    seq: np.ndarray        # [P] hop-frequency indices (host)
    hop_len: int


def make_fhss_params(freqs, seq, hop_len: int) -> FhssParams:
    freqs = np.asarray(freqs, np.float64)
    seq = np.asarray(seq, np.int64)
    if seq.size == 0:
        raise ValueError("empty hop sequence")
    if seq.min() < 0 or seq.max() >= freqs.size:
        raise ValueError("sequence indexes outside the frequency table")
    return FhssParams(freqs=freqs, seq=seq, hop_len=int(hop_len))


def _hop_phasors(params: FhssParams, k: int, seq_phase: int, sign: float, device
                 ) -> torch.Tensor:
    """[k, L] per-segment tones at the sequence's frequencies (float64 phase
    on the host, each hop restarting at phase 0), complex64 on `device`."""
    idx = params.seq[(seq_phase + np.arange(k)) % params.seq.size]
    f = params.freqs[idx][:, None]                         # [k, 1]
    n = np.arange(params.hop_len)[None, :]
    return torch.as_tensor(np.exp(2j * np.pi * sign * f * n).astype(np.complex64), device=device)


def _mix_hops(params: FhssParams, x: torch.Tensor, seq_phase: int, sign: float
              ) -> torch.Tensor:
    """Mix every hop segment with its tone, including a ragged final partial
    hop (padded to a whole segment and trimmed back)."""
    l = params.hop_len
    n = x.shape[-1]
    k = -(-n // l)
    pad = k * l - n
    xp = (torch.cat([x, torch.zeros((*x.shape[:-1], pad), dtype=x.dtype, device=x.device)],
                    dim=-1) if pad else x)
    xb = xp.reshape(*x.shape[:-1], k, l)
    y = xb * _hop_phasors(params, k, seq_phase, sign, x.device)
    return y.reshape(*x.shape[:-1], k * l)[..., :n].to(CF32)


def fhss_hop(params: FhssParams, x: torch.Tensor, seq_phase: int = 0) -> torch.Tensor:
    """Spread: x [..., N] baseband -> hopped (same length). Segment k is mixed
    to freqs[seq[(seq_phase+k) % P]]."""
    return _mix_hops(params, x, seq_phase, +1.0)


def fhss_dehop(params: FhssParams, x: torch.Tensor, seq_phase: int = 0) -> torch.Tensor:
    """Despread with known hop timing: x starts at a hop boundary whose
    sequence position is seq_phase (same length out)."""
    return _mix_hops(params, x, seq_phase, -1.0)


def fhss_acquire(params: FhssParams, x, coarse: int = 8, device=None) -> tuple[int, int]:
    """Blind hop-timing + sequence-phase acquisition over `coarse` timing
    offsets per hop (L/coarse-sample granularity). Returns (sample_offset,
    seq_phase) of the best hypothesis. A non-tensor x goes to `device`
    (None = the card)."""
    x = as_tensor_on(x, device, CF32)
    l = params.hop_len
    p = params.seq.size
    n = np.arange(l)
    tones = torch.as_tensor(np.exp(-2j * np.pi * params.freqs[None, :] * n[:, None])
                            .astype(np.complex64), device=x.device)          # [L, H]
    if x.shape[-1] < (p + 1) * l:
        raise ValueError(f"capture too short for acquisition: need >= {(p + 1) * l} "
                         f"samples (P+1 hops), got {x.shape[-1]}")
    pin_f32(x)
    best = (-1.0, 0, 0)
    for c in range(coarse):
        off = c * l // coarse
        k = (x.shape[-1] - off) // l
        if k < p:
            continue
        xb = x[off:off + k * l].reshape(k, l)
        e = torch.abs(xb @ tones) ** 2                     # [K, H]
        cls = torch.argmax(e, dim=-1).cpu().numpy()         # [K]
        conf = float(torch.mean(torch.amax(e, dim=-1) / (torch.sum(e, dim=-1) + 1e-30)))
        hits = np.array([np.mean(cls == params.seq[(ph + np.arange(k)) % p])
                         for ph in range(p)])
        ph = int(np.argmax(hits))
        score = float(hits[ph]) * conf
        if score > best[0]:
            best = (score, off, ph)
    return best[1], best[2]
