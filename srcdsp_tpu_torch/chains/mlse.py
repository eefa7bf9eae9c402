"""MLSE equalizer: Viterbi sequence detection over a known ISI channel
(counterpart of ``srcdsp_tpu/chains/mlse.py``).

State = the last L-1 symbols, branch metric |y_n - sum_l h_l s_{n-l}|^2:

- all M^L expected channel outputs are a host-built table, so the branch
  metrics of every (state, input) edge at every step are one broadcast
  |y - e|^2 on the device, computed before the loop (the same elementwise
  arithmetic the reference computes per step);
- add-compare-select over the [S] path metrics runs as a Python loop over
  symbols of batched torch ops (the reference's `lax.scan`), decisions
  stored as [N, S]; the survivor choice is the first minimum (`argmin`, as
  `jnp.argmin` takes it);
- traceback reads the decisions back to the host once and walks them in a
  numpy loop (integer state arithmetic, exact).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from srcdsp_tpu_torch.demap import psk_points
from srcdsp_tpu_torch.types import CF32, F32

__all__ = ["MlseTrellis", "make_mlse", "mlse_equalize"]


class MlseTrellis(NamedTuple):
    points: np.ndarray     # [M] constellation
    h: np.ndarray          # [L] channel
    expected: np.ndarray   # [S, M] complex: channel output for (state, m)
    order: int
    mem: int               # L-1 symbols of memory


def make_mlse(h, order: int = 2, points=None) -> MlseTrellis:
    """Build the trellis (host numpy) for channel taps h [L] (h[0] = current
    symbol) and an M-point constellation (default M-PSK with the chains.psk
    convention; `points` for any other)."""
    h = np.asarray(h, np.complex128)
    l = h.size
    if points is not None:
        pts = np.asarray(points, np.complex128)
        m = pts.size
    else:
        m = int(order)
        pts = np.asarray(psk_points(m), np.complex128)
    mem = l - 1
    s_count = m ** mem
    # state s encodes (s_1..s_mem), newest first, base-M digits (most
    # significant digit = newest symbol)
    expected = np.zeros((s_count, m), np.complex128)
    for s in range(s_count):
        digs = [(s // m ** (mem - 1 - i)) % m for i in range(mem)]
        past = sum(h[1 + i] * pts[digs[i]] for i in range(mem))
        for u in range(m):
            expected[s, u] = h[0] * pts[u] + past
    return MlseTrellis(points=pts.astype(np.complex64), h=h.astype(np.complex64),
                       expected=expected.astype(np.complex64), order=m, mem=mem)


def mlse_equalize(tr: MlseTrellis, y: torch.Tensor) -> torch.Tensor:
    """Detect the ML symbol sequence. y: [N] symbol-rate channel output
    (synchronized). Returns [N] int32 constellation indices on y's device
    (the last `mem` symbols come from the best final state)."""
    m, mem = tr.order, tr.mem
    dev = y.device
    y = y.to(CF32)
    if mem == 0:                         # flat channel: nearest point
        pts = torch.as_tensor(tr.points * tr.h[0], device=dev)
        return torch.argmin(torch.abs(y[..., None] - pts) ** 2, dim=-1).to(torch.int32)
    s_count = m ** mem
    exp = torch.as_tensor(tr.expected.reshape(-1), device=dev)          # [S*M]
    bm_all = (torch.abs(y[:, None] - exp) ** 2).reshape(-1, s_count, m)  # [N, S, M]
    pm = torch.zeros((s_count,), dtype=F32, device=dev)
    decs = []
    for bm in bm_all:
        # edges (s, u) land on s' = u*M^(mem-1) + s//M; with s = d*M + r the
        # M states sharing d compete for each u
        c = (pm[:, None] + bm).reshape(-1, m, m)        # [d, r, u]
        best_r = torch.argmin(c, dim=1)                 # [d, u]
        val = torch.amin(c, dim=1)
        pm2 = val.T.reshape(-1)                         # [u*D + d] = s'
        decs.append(best_r.T.reshape(-1))               # dropped digit r
        pm = pm2 - torch.max(pm2)
    s = int(torch.argmin(pm))
    decs = torch.stack(decs).cpu().numpy()              # [N, S]
    top = m ** (mem - 1)
    us = np.empty(decs.shape[0], np.int64)
    for n in range(decs.shape[0] - 1, -1, -1):
        us[n] = s // top                                # newest digit of s'
        s = (s % top if mem > 1 else 0) * m + int(decs[n, s])
    return torch.as_tensor(us, dtype=torch.int32, device=dev)
