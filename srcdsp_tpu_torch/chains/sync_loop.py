"""Sequential tracking loops (counterpart of ``srcdsp_tpu/chains/sync_loop.py``).

The feedforward estimators in ``chains.sync`` and ``chains.psk`` have no
recurrence. These loops track a symbol clock or a carrier that drifts within
a block, one step per SYMBOL:

- `gardner_scan`: Gardner TED + 2nd-order loop on a complex baseband at sps
  samples/symbol; carries (tau, freq) fractional timing state.
- `gardner_free_scan`: the skip/stuff form, whose strobe position free-runs
  so that a sustained clock offset changes the emitted symbol count.
- `costas_scan`: M-th-power Costas loop for M-PSK on symbol-rate samples;
  carries (phase, freq).

The reference's ``lax.scan`` is a Python loop over steps here; each step is
a few batched tensor operations over the channels (``torch.gather`` for
``take_along_axis``) and reads nothing back to the host, so the card never
waits on a step. The loops run on (re, im) float32 planes, one core each for
these complex forms and the plane forms of ``chains.tracking_planes``: the
complex products expand to the same float32 operations.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.ops.cpow import cpow
from srcdsp_tpu_torch.ops.nco import TWO_PI, _mod_f32
from srcdsp_tpu_torch.types import CF32, F32


class GardnerState(NamedTuple):
    tau: torch.Tensor    # [...] fractional timing offset in samples
    freq: torch.Tensor   # [...] timing frequency (samples/symbol drift)


def gardner_init(channel_shape: tuple = (), tau0: float = 0.0, device=None) -> GardnerState:
    device = resolve(device)
    return GardnerState(tau=torch.full(channel_shape, tau0, dtype=F32, device=device),
                        freq=torch.zeros(channel_shape, dtype=F32, device=device))


def _planes(x: torch.Tensor) -> torch.Tensor:
    """complex [..., N] -> planes [..., 2, N]."""
    return torch.stack([x.real, x.imag], dim=-2)


def _interp_pair(xp: torch.Tensor, ta: torch.Tensor, tb: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Linear interpolation of planes xp [..., P, N] at two positions per
    channel (ta, tb: [...]), one gather for both: the reference's `_interp`
    twice, ([..., P], [..., P]). The fraction is taken from the unclipped
    floor, then the index is clipped to [0, N-2], as there."""
    n = xp.shape[-1]
    t = torch.stack([ta, tb], dim=-1)[..., None, :]               # [..., 1, 2]
    fl = torch.floor(t)
    frac = t - fl
    i0 = torch.clamp(fl, 0, n - 2).to(torch.int64)
    idx = torch.cat([i0, i0 + 1], dim=-1).expand(*xp.shape[:-1], 4)
    g = torch.gather(xp, -1, idx)                                 # [..., P, 4]
    y = g[..., :2] * (1.0 - frac) + g[..., 2:] * frac
    return y[..., 0], y[..., 1]


def _ted(y: torch.Tensor, prev: torch.Tensor, ymid: torch.Tensor) -> torch.Tensor:
    """Gardner error Re{(y - prev) * conj(ymid)} over the planes [..., P]
    (P = 2: re, im; P = 1: a real stream, whose imag plane is zero)."""
    p = (y - prev) * ymid
    return p[..., 0] if p.shape[-1] == 1 else p[..., 0] + p[..., 1]


def gardner_planes(tau: torch.Tensor, freq: torch.Tensor, xp: torch.Tensor, sps: int,
                   kp: float, ki: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The bounded Gardner loop on planes xp [..., P, N]: (tau, freq,
    symbols [..., P, N/sps - 1]). The error is positive when sampling late,
    so the loop subtracts it; tau is carried unwrapped (the per-step clip
    bounds it): a wrap at a block seam would slip a whole symbol."""
    nsym = xp.shape[-1] // sps - 1
    prev = torch.zeros((*tau.shape, xp.shape[-2]), dtype=F32, device=xp.device)
    out = []
    for k in range(nsym):
        t = tau + float(k * sps)
        # midpoint between the previous strobe and this one
        y, ymid = _interp_pair(xp, t, t - sps / 2.0)
        e = _ted(y, prev, ymid)
        freq = freq - ki * e
        tau = torch.clamp(tau - kp * e + freq, -sps / 2.0, 1.5 * sps)
        prev = y
        out.append(y)
    return tau, freq, torch.stack(out, dim=-1)


def gardner_scan(state: GardnerState, x: torch.Tensor, sps: int, kp: float = 0.5,
                 ki: float = 0.02) -> tuple[GardnerState, torch.Tensor]:
    """Track symbol timing through one block. x: [..., N] complex, N % sps == 0.

    Returns (state, symbols [..., N/sps - 1] complex64): one symbol per
    strobe, the final partial strobe carried into tau for the next block.
    """
    tau, freq, y = gardner_planes(state.tau, state.freq, _planes(x), sps, kp, ki)
    return GardnerState(tau=tau, freq=freq), torch.complex(y[..., 0, :], y[..., 1, :])


class GardnerFreeState(NamedTuple):
    """Free-running (skip/stuff) timing state: the strobe position is an
    unbounded accumulator, so sustained ppm offsets change the emitted symbol
    count instead of shearing the stream."""

    pos: torch.Tensor    # [...] next strobe position in buffer coords
    freq: torch.Tensor   # [...] samples/symbol deviation from nominal sps
    prev: torch.Tensor   # [...] complex64 previous strobe value


def gardner_free_init(channel_shape: tuple = (), tau0: float = 0.0,
                      device=None) -> GardnerFreeState:
    device = resolve(device)
    return GardnerFreeState(pos=torch.full(channel_shape, tau0, dtype=F32, device=device),
                            freq=torch.zeros(channel_shape, dtype=F32, device=device),
                            prev=torch.zeros(channel_shape, dtype=CF32, device=device))


def gardner_free_cap(n: int, sps: int, max_dev: float) -> int:
    """Static output capacity for a block of n samples: the most strobes a
    clock running max_dev fast can emit, plus seam slack."""
    return int(math.ceil((n + sps) / (sps * (1.0 - max_dev)))) + 2


def gardner_free_planes(pos, freq, prev, xp: torch.Tensor, sps: int, kp: float, ki: float,
                        max_dev: float):
    """The skip/stuff loop on planes xp [..., P, sps + N] from (pos, freq,
    prev [..., P]): ((pos re-based by -N, freq, prev), (symbols [..., P, K],
    valid [..., K])), K = gardner_free_cap(N, sps, max_dev). freq is clipped
    to +-max_dev*sps and the advance to [0.5, 1.5]*sps, so K is a true
    bound; a strobe past the block freezes the loop and re-fires in the next
    block."""
    nbuf = xp.shape[-1]
    n = nbuf - sps
    limit = float(nbuf - 2)          # last interp-safe strobe position
    fmax = float(max_dev * sps)
    ys, vs = [], []
    for _ in range(gardner_free_cap(n, sps, max_dev)):
        y, ymid = _interp_pair(xp, pos, pos - (sps + freq) / 2.0)
        e = _ted(y, prev, ymid)
        valid = pos <= limit
        freq = torch.where(valid, torch.clamp(freq - ki * e, -fmax, fmax), freq)
        adv = torch.clamp(sps + freq - kp * e, 0.5 * sps, 1.5 * sps)
        pos = torch.where(valid, pos + adv, pos)
        prev = torch.where(valid[..., None], y, prev)
        ys.append(y)
        vs.append(valid)
    # re-base for the next block's buffer (its tail re-covers [n, n+sps))
    return (pos - n, freq, prev), (torch.stack(ys, dim=-1), torch.stack(vs, dim=-1))


def gardner_free_scan(state: GardnerFreeState, x: torch.Tensor, sps: int, kp: float = 0.5,
                      ki: float = 0.02, max_dev: float = 0.05
                      ) -> tuple[GardnerFreeState, tuple[torch.Tensor, torch.Tensor]]:
    """Skip/stuff Gardner tracking: unbounded sustained clock offsets.

    x: [..., sps + N] complex (the caller prepends its carried sps-sample
    tail). Returns (state, (symbols [..., K] complex64, valid [..., K] bool))
    with K = gardner_free_cap(N, sps, max_dev); masked-off lanes hold frozen
    values.
    """
    prev = torch.stack([state.prev.real, state.prev.imag], dim=-1)
    (pos, freq, prev), (y, valid) = gardner_free_planes(state.pos, state.freq, prev,
                                                        _planes(x), sps, kp, ki, max_dev)
    return (GardnerFreeState(pos=pos, freq=freq, prev=torch.complex(prev[..., 0], prev[..., 1])),
            (torch.complex(y[..., 0, :], y[..., 1, :]), valid))


class CostasState(NamedTuple):
    phase: torch.Tensor  # [...] radians
    freq: torch.Tensor   # [...] radians/symbol


def costas_init(channel_shape: tuple = (), device=None) -> CostasState:
    device = resolve(device)
    return CostasState(phase=torch.zeros(channel_shape, dtype=F32, device=device),
                       freq=torch.zeros(channel_shape, dtype=F32, device=device))


def costas_planes(state: CostasState, sr: torch.Tensor, si: torch.Tensor, order: int,
                  kp: float, ki: float, rot: tuple[float, float],
                  valid: torch.Tensor | None = None
                  ) -> tuple[CostasState, tuple[torch.Tensor, torch.Tensor]]:
    """The Costas loop on symbol-rate planes sr/si [..., K]: e = atan2 of
    y^M (repeated complex squaring) times rot = (cos, sin) of the
    constellation's -2*pi*offset, over M. `valid` freezes the loop on masked
    strobes. Returns the state (phase mod 2*pi) and the derotated planes."""
    rot_r, rot_i = rot
    ph, fr = state.phase, state.freq
    outr, outi = [], []
    for k in range(sr.shape[-1]):
        s_r, s_i = sr[..., k], si[..., k]
        c = torch.cos(ph)
        s = torch.sin(ph)
        yr = s_r * c + s_i * s          # s * e^{-j ph}
        yi = s_i * c - s_r * s
        pr, pi = cpow(yr, yi, order)
        er = pr * rot_r - pi * rot_i    # y^M * rot
        ei = pr * rot_i + pi * rot_r
        e = torch.atan2(ei, er) / order
        fr2 = fr + ki * e
        ph2 = ph + kp * e + fr2
        if valid is not None:
            v = valid[..., k]
            fr2 = torch.where(v, fr2, fr)
            ph2 = torch.where(v, ph2, ph)
        ph, fr = ph2, fr2
        outr.append(yr)
        outi.append(yi)
    return (CostasState(phase=_mod_f32(ph, TWO_PI), freq=fr),
            (torch.stack(outr, dim=-1), torch.stack(outi, dim=-1)))


def costas_scan(state: CostasState, sym: torch.Tensor, order: int, kp: float = 0.1,
                ki: float = 0.01, offset: float = 0.0, valid: torch.Tensor | None = None
                ) -> tuple[CostasState, torch.Tensor]:
    """Carrier tracking over symbol-rate samples. sym: [..., K] complex.

    Phase error e = angle(y^M * e^{-j*2*pi*offset})/M, which needs no
    decisions; `offset` is the constellation offset (0.5 for diagonal QPSK).
    Returns derotated symbols. `valid` ([..., K] bool, from
    gardner_free_scan) freezes the loop on masked strobes. The rotation is
    the complex64 exponential, as the reference computes it.
    """
    rot = torch.exp(torch.tensor(-1j * TWO_PI * offset, dtype=CF32))
    st, (yr, yi) = costas_planes(state, sym.real, sym.imag, order, kp, ki,
                                 (float(rot.real), float(rot.imag)), valid)
    return st, torch.complex(yr, yi)


def plane_rotation(offset: float) -> tuple[float, float]:
    """(cos, sin) of -2*pi*offset in float64, rounded to float32: the plane
    forms' constellation rotation, as the reference's plane twin builds it."""
    return (float(np.float32(np.cos(-TWO_PI * offset))),
            float(np.float32(np.sin(-TWO_PI * offset))))
