"""HDLC-style framing: bit stuffing, flag detection (counterpart of
``srcdsp_tpu/hdlc.py``).

- Run lengths without a loop: the run of 1s ending at position i is
  i - last_zero_index(i), and last_zero_index is a `torch.cummax` over
  i * (b == 0), seeded with the run carried in from the previous block.
- Stuff/destuff are ragged: both return values plus a validity mask of
  static capacity; `compact_bits` squeezes them on the host at the sink.
- Flag detection (01111110) is an exact-match correlation of +-1 bits:
  positions fall out of a compare.
"""

from __future__ import annotations

import numpy as np
import torch

from srcdsp_tpu_torch.types import F32

__all__ = ["FLAG", "stuff_bits", "destuff_bits", "find_flags", "compact_bits"]

FLAG = np.asarray([0, 1, 1, 1, 1, 1, 1, 0], np.int32)
I32 = torch.int32


def _ones_run(b: torch.Tensor, run0=0) -> torch.Tensor:
    """run[i] = number of consecutive 1s ENDING at position i; `run0` is
    the run carried in from the previous block (streaming)."""
    i = torch.arange(b.shape[-1], device=b.device)
    seed = -(torch.as_tensor(run0, device=b.device).to(i.dtype) + 1)   # virtual last zero
    last_zero = torch.cummax(torch.where(b == 0, i, seed), dim=-1).values
    return i - last_zero


def stuff_bits(bits: torch.Tensor, run0=0
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Insert a 0 after every run of five 1s. bits: [N] {0,1}.

    Returns (out [ceil(6N/5)] int32, valid [same] bool, run_out): the
    stuffed stream occupies the valid positions in order (compact with
    `compact_bits`). For block streaming pass the previous call's run_out
    as `run0`; run_out is the run AFTER the final (possibly stuffed) bit.
    """
    b = bits.to(I32)
    n = b.shape[-1]
    run = _ones_run(b, run0)
    # a stuffed 0 goes AFTER position i whenever the run there is 5, 10, ...
    ins = (run > 0) & (torch.remainder(run, 5) == 0)
    insi = ins.to(torch.int64)
    pos = torch.arange(n, device=b.device) + torch.cumsum(insi, dim=-1) - insi
    cap = n + (n + 4) // 5
    # cap + 1 slots: bits that insert nothing write False into the dummy
    # last slot (duplicate writes of one value, so their order is moot),
    # which is cut away; every other index is written once
    out = torch.zeros(cap + 1, dtype=I32, device=b.device)
    valid = torch.zeros(cap + 1, dtype=torch.bool, device=b.device)
    out[pos] = b
    valid[pos] = True
    zidx = torch.where(ins, pos + 1, torch.full_like(pos, cap))
    valid[zidx] = ins
    run_out = torch.where(b[n - 1] == 0, 0, torch.remainder(run[n - 1], 5)).to(I32)
    return out[:cap], valid[:cap], run_out


def destuff_bits(bits: torch.Tensor, run0=0
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Delete every 0 that follows exactly five 1s. bits: [N] {0,1}.
    Returns (out [N] int32, valid [N] bool, run_out): ragged, compact at
    the sink; thread run_out -> run0 across streamed blocks."""
    b = bits.to(I32)
    run = _ones_run(b, run0)
    head = torch.as_tensor(run0, device=b.device).to(run.dtype).reshape(1)
    prev_run = torch.cat([head, run[:-1]])
    stuffed = (b == 0) & (torch.remainder(prev_run, 5) == 0) & (prev_run > 0)
    run_out = torch.where(b[-1] == 0, 0, run[-1]).to(I32)
    return b, ~stuffed, run_out


def find_flags(bits: torch.Tensor) -> torch.Tensor:
    """Boolean mask: True where an HDLC flag 01111110 STARTS. Exact-match
    correlation of +-1 bits against the +-1 flag (peak == 8; integer sums,
    exact in float32)."""
    n = bits.shape[-1]
    if n < 8:
        return torch.zeros(n, dtype=torch.bool, device=bits.device)
    pm = 2.0 * bits.to(F32) - 1.0
    fl = torch.as_tensor(2.0 * FLAG.astype(np.float32) - 1.0, device=bits.device)
    score = (pm.unfold(-1, 8, 1) * fl).sum(dim=-1)
    hits = score == 8.0
    return torch.cat([hits, torch.zeros(7, dtype=torch.bool, device=bits.device)])


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def compact_bits(vals, valid) -> np.ndarray:
    """Host sink: squeeze the ragged (vals, valid) stream."""
    return _host(vals)[_host(valid)]
