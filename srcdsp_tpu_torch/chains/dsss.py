"""Direct-sequence spread spectrum: spread, acquire, despread (counterpart of
``srcdsp_tpu/chains/dsss.py``).

The spreading code is an LFSR m-sequence (host design time), and both
receive stages are single matrix products:

- acquisition (code-phase search): every cyclic shift of the code is a row
  of a fixed [SF, SF] matrix, so correlating a window of symbol-length
  frames against all phases is one [F, SF] @ [SF, SF] product; the phase is
  the argmax of the summed |correlation| (noncoherent);
- despread: with the phase known, symbols are frame dot products against
  the aligned code, one [nsym, SF] @ [SF] product after a roll.

The products run in float32 (complex64 for complex streams) with TF32 off
(``ops.fir.pin_f32``), on the stream's device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.ops.fir import pin_f32
from srcdsp_tpu_torch.types import F32

__all__ = ["DsssParams", "make_dsss_params", "pn_msequence", "gold_family", "dsss_spread",
           "dsss_acquire", "dsss_despread", "dsss_demod_bpsk", "dsss_finger_search",
           "dsss_rake_demod"]


def pn_msequence(taps, order: int) -> np.ndarray:
    """Maximal-length LFSR sequence (Fibonacci form), chips in {+1, -1}
    (bit 0 -> +1). taps: feedback tap positions (1-based, e.g. [6, 1] for
    x^6+x+1). Length 2^order - 1; host-side."""
    state = [1] * order
    out = []
    for _ in range((1 << order) - 1):
        out.append(state[-1])
        fb = 0
        for t in taps:
            fb ^= state[t - 1]
        state = [fb] + state[:-1]
    return 1.0 - 2.0 * np.asarray(out, np.float32)


def gold_family(taps1, taps2, order: int) -> np.ndarray:
    """Gold code family from a preferred pair of m-sequences: the two
    sequences plus all 2^order - 1 relative-shift XORs (products in the +-1
    domain), [2^order + 1, 2^order - 1] chips in {+1, -1}. Host-side."""
    u = pn_msequence(taps1, order)
    v = pn_msequence(taps2, order)
    fam = [u, v]
    for shift in range(u.size):
        fam.append(u * np.roll(v, -shift))
    return np.stack(fam).astype(np.float32)


class DsssParams(NamedTuple):
    chips: torch.Tensor    # [SF] +-1 spreading code
    shifts: torch.Tensor   # [SF, SF] row p = code cyclically shifted by p
    sf: int


def make_dsss_params(taps=(6, 1), order: int = 6, chips: np.ndarray | None = None,
                     device=None) -> DsssParams:
    """DSSS params from LFSR taps (m-sequence of length 2^order-1) or an
    explicit +-1 chip vector, on `device` (None = the card)."""
    if chips is None:
        chips = pn_msequence(taps, order)
    chips = np.asarray(chips, np.float32)
    shifts = np.stack([np.roll(chips, -p) for p in range(chips.size)])
    device = resolve(device)
    return DsssParams(chips=torch.as_tensor(chips, device=device),
                      shifts=torch.as_tensor(shifts, device=device), sf=int(chips.size))


def dsss_spread(params: DsssParams, symbols: torch.Tensor) -> torch.Tensor:
    """Spread symbols [..., S] (+-1 BPSK or any complex constellation) ->
    chips [..., S*SF]."""
    y = symbols[..., :, None] * params.chips
    return y.reshape(*symbols.shape[:-1], -1)


def dsss_finger_search(params: DsssParams, x: torch.Tensor, frames: int | None = None
                       ) -> torch.Tensor:
    """Per-code-phase noncoherent energy metric [SF] (several peaks under
    multipath: the RAKE finger map): whole symbol-length frames against all
    SF cyclic shifts in one product, |.| summed over frames."""
    sf = params.sf
    nf = x.shape[-1] // sf - 1
    if frames is not None:
        nf = min(nf, frames)
    w = x[: nf * sf].reshape(nf, sf)
    pin_f32(w)
    corr = w @ params.shifts.T.to(w.dtype)
    return torch.sum(torch.abs(corr), dim=0)


def dsss_acquire(params: DsssParams, x: torch.Tensor, frames: int | None = None
                 ) -> torch.Tensor:
    """Noncoherent code-phase search over a chip stream x [N] (N >= 2*SF):
    the code phase p in [0, SF) (the argmax of `dsss_finger_search`)."""
    return torch.argmax(dsss_finger_search(params, x, frames))


def dsss_despread(params: DsssParams, x: torch.Tensor, phase) -> torch.Tensor:
    """Despread chips [N] at the acquired code phase -> symbols [N//SF - 1]
    (the first code-aligned frame starts (SF-phase)%SF chips in; a roll whose
    wrapped tail falls only into the dropped final frame). A tensor phase is
    read to the host once for the roll."""
    sf = params.sf
    nsym = x.shape[-1] // sf - 1
    off = (sf - int(phase)) % sf
    xr = torch.roll(x, -off)[: nsym * sf]
    w = xr.reshape(nsym, sf)
    pin_f32(w)
    return (w @ params.chips.to(w.dtype)) * np.float32(1.0 / sf)


def dsss_demod_bpsk(params: DsssParams, x: torch.Tensor, phase
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Despread + carrier-phase-blind BPSK slice (the squared-symbol carrier
    estimate; its pi ambiguity resolved by a +1 pilot as symbol 0). Returns
    (bits [nsym] int32, soft [nsym] float32)."""
    sym = dsss_despread(params, x, phase)
    if sym.is_complex():
        ang = torch.angle(torch.sum(sym * sym)) / 2.0
        soft = (sym * torch.exp(-1j * ang)).real
    else:
        soft = sym.to(F32)
    soft = soft * torch.sign(soft[0])                  # pilot polarity
    return (soft < 0).to(torch.int32), soft


def dsss_rake_demod(params: DsssParams, x: torch.Tensor, base_phase, delays,
                    min_weight: float = 0.1) -> tuple[torch.Tensor, torch.Tensor]:
    """RAKE: despread each multipath finger (extra chip delays `delays`
    relative to `base_phase`, zero-filled) and maximal-ratio combine with
    blind per-finger gains from the squared despread symbols; fingers below
    min_weight of the strongest are zeroed. Returns (bits [nsym] int32, soft
    [nsym] float32)."""
    syms = []
    for d in delays:
        d = int(d)
        xd = (torch.cat([x[..., d:], torch.zeros((*x.shape[:-1], d), dtype=x.dtype,
                                                 device=x.device)], dim=-1) if d else x)
        syms.append(dsss_despread(params, xd, base_phase))
    # the zero fill can shave the tail symbol: drop one more on every finger
    syms = [s_[..., :-1] for s_ in syms]
    weights = []
    parts = []
    for sym in syms:
        if sym.is_complex():
            g2 = torch.mean(sym * sym)
            a = torch.sqrt(torch.abs(g2) + 1e-30)
            comp = (sym * torch.exp(-1j * (torch.angle(g2) / 2.0))).real
        else:
            comp = sym.to(F32)
            a = torch.sqrt(torch.abs(torch.mean(comp * comp)) + 1e-30)
        comp = comp * torch.sign(comp[0])    # pilot pins the pi ambiguity
        parts.append(comp)
        weights.append(a)
    wmax = torch.max(torch.stack(weights))
    zero = torch.zeros((), dtype=F32, device=x.device)
    soft = sum(torch.where(w > min_weight * wmax, w, zero) * p for w, p in zip(weights, parts))
    return (soft < 0).to(torch.int32), soft.to(F32)
