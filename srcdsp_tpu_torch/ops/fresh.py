"""FRESH (FREquency-SHift) filtering, cyclostationarity-exploiting LMMSE
interference rejection (counterpart of ``srcdsp_tpu/ops/fresh.py``).

A FRESH filter is a bank of FIR branches, each fed a frequency-shifted
(optionally conjugated) copy of the input, summed:

    y[n] = sum_b (h_b * x_b)[n],   x_b[n] = shift(x, alpha_b)[n]
                                    or shift(conj(x), alpha_b)[n]

Because the target's shifted copies are coherent with it while an
interferer's are not, the joint LMMSE solve cancels co-channel interference a
stationary (Wiener) filter cannot touch; a canceller needs the interferer's
cycles too (`merge_branches`).

Where each part runs:

- the branch sets (`bpsk_branches`, `merge_branches`), the cycle refinement
  (`refine_cycle`), the moment-line picks and the blind branch design are
  host numpy, the port's own copy of the reference's;
- the shift rotators take their phase from the global sample index n0 + k in
  float64 on the host, frac() rounded to float32 (part of the filter's time
  reference: `n0` keeps them phase-continuous across blocks), then cos/sin
  in float32 on the device;
- the regressors [N - taps + 1, B*taps] are strided views of the shifted
  copies, the design's Gram and cross are matmuls with TF32 off and the
  ridge-regularised [BT, BT] solve is `torch.linalg.solve`; `fresh_apply`
  runs the same product in row chunks, so a long block never holds its
  whole regressor matrix.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from srcdsp_tpu_torch.device import as_tensor_on
from srcdsp_tpu_torch.ops.fir import pin_f32
from srcdsp_tpu_torch.types import CF32

__all__ = ["FreshBranch", "FreshFilter", "bpsk_branches",
           "merge_branches", "refine_cycle", "blind_bpsk_branches",
           "fresh_frames", "fresh_design", "fresh_apply"]

# rows of the regressor matrix formed at once by fresh_apply
APPLY_ROWS = 1 << 16


class FreshBranch(NamedTuple):
    alpha: float            # frequency shift, cycles/sample
    conj: bool              # feed conj(x) (conjugate-cycle branch)


class FreshFilter(NamedTuple):
    weights: torch.Tensor   # [B*T] c64 stacked branch taps
    branches: tuple         # tuple[FreshBranch]
    taps: int
    delay: int              # target alignment delay used in design


def bpsk_branches(fc: float, baud: float, harmonics: int = 1) -> tuple:
    """The textbook BPSK cycle set for a target at carrier fc (at complex
    baseband) and symbol rate `baud`: non-conjugate branches at
    {0, +-k*baud} and conjugate branches at {2fc, 2fc +- k*baud}."""
    br = [FreshBranch(0.0, False)]
    for k in range(1, harmonics + 1):
        br += [FreshBranch(+k * baud, False), FreshBranch(-k * baud, False)]
    br.append(FreshBranch(2 * fc, True))
    for k in range(1, harmonics + 1):
        br += [FreshBranch(2 * fc + k * baud, True), FreshBranch(2 * fc - k * baud, True)]
    return tuple(br)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def refine_cycle(x, alpha0: float, conj: bool, span: float = 2e-3,
                 points: int = 81) -> float:
    """Refine a coarse cycle-frequency estimate on the cyclic-moment line
    C(alpha) = |sum_n v[n] e^{-j2pi alpha n}| (v = x^2 for conjugate cycles,
    |x|^2 for non-conjugate ones): a grid scan over +-span, then a 3-point
    parabolic peak fit (host numpy; rotators per chunk of 8 grid points with
    the float64 frac phase)."""
    xv = _host(x)
    v = xv * xv if conj else (xv * np.conj(xv)).real.astype(np.complex64)
    n = v.shape[-1]
    grid = np.linspace(alpha0 - span, alpha0 + span, points)
    idx = np.arange(n, dtype=np.float64)
    c = np.empty(points)
    for lo in range(0, points, 8):
        g = grid[lo: lo + 8]
        fr = np.mod(g[:, None] * idx[None, :], 1.0)
        rot = np.exp(-2j * np.pi * fr).astype(np.complex64)
        c[lo: lo + 8] = np.abs(rot @ v)
    k = int(np.argmax(c))
    if 0 < k < points - 1:
        y0, y1, y2 = c[k - 1], c[k], c[k + 1]
        denom = y0 - 2 * y1 + y2
        off = 0.5 * (y0 - y2) / denom if abs(denom) > 1e-12 else 0.0
    else:
        off = 0.0
    step = grid[1] - grid[0]
    return float(grid[k] + off * step)


def _moment_lines(v: np.ndarray, n_lines: int, min_sep: float, guard: float,
                  fold: bool = False) -> list[float]:
    """Strongest spectral lines of a cyclic-moment sequence v: FFT magnitude
    peaks, greedily picked with a minimum separation and a DC guard;
    fold=True treats +-f as one line (baud lines come in pairs)."""
    spec = np.abs(np.fft.fft(v * np.hanning(v.size)))
    freqs = np.fft.fftfreq(v.size)
    order = np.argsort(spec)[::-1]
    out = []
    for k in order:
        f = float(freqs[k])
        if abs(f) < guard:
            continue
        key = abs(f) if fold else f
        if any(abs(key - (abs(g) if fold else g)) < min_sep for g in out):
            continue
        out.append(f)
        if len(out) >= n_lines:
            break
    return out


def blind_bpsk_branches(x, n_signals: int = 2, min_sep: float = 5e-3) -> tuple:
    """Blind branch design for a mixture of BPSK-class signals (host):
    carrier lines from FFT(x^2), baud lines from FFT(|x|^2), each refined by
    `refine_cycle`, then alpha = 0, +-each baud and, for every carrier, the
    conjugate branches {2fc, 2fc +- each baud}."""
    xv = _host(x)
    carriers = _moment_lines(xv * xv, n_signals, min_sep, guard=0.0)
    bauds = _moment_lines((xv * np.conj(xv)).real, n_signals, min_sep, guard=2e-2, fold=True)
    carriers = [refine_cycle(xv, c, True) for c in carriers]
    bauds = [abs(refine_cycle(xv, b, False)) for b in bauds]
    br = [FreshBranch(0.0, False)]
    for b in bauds:
        br += [FreshBranch(+b, False), FreshBranch(-b, False)]
    for c in carriers:
        br.append(FreshBranch(c, True))
        for b in bauds:
            br += [FreshBranch(c + b, True), FreshBranch(c - b, True)]
    return merge_branches(br)


def merge_branches(*sets) -> tuple:
    """Order-preserving union of branch sets."""
    out = []
    for s in sets:
        for br in s:
            if br not in out:
                out.append(br)
    return tuple(out)


def _shifted(x: torch.Tensor, branch: FreshBranch, n0: int) -> torch.Tensor:
    """x (or conj(x)) times the branch rotator at global index n0 + k: the
    frac phase in float64 on the host, 2*pi*frac in float32, cos/sin in
    float32 on x's device."""
    n = x.shape[-1]
    idx = np.arange(n, dtype=np.float64) + float(n0)
    fr = np.mod(branch.alpha * idx, 1.0).astype(np.float32)
    ph = torch.as_tensor(2.0 * np.pi * fr, device=x.device)
    rot = torch.complex(torch.cos(ph), torch.sin(ph))
    return (torch.conj(x) if branch.conj else x) * rot


def fresh_frames(x, branches: Sequence[FreshBranch], taps: int, n0: int = 0,
                 device=None) -> torch.Tensor:
    """[N] -> regressor matrix [N - taps + 1, B*taps]: row n holds every
    branch's `taps`-sample window starting at n (column b*taps + t is branch
    b's sample n + t). n0 = global index of x[0] (a tensor stays on its
    device, anything else goes to `device`, None = the card)."""
    x = as_tensor_on(x, device, CF32)
    return torch.cat([_shifted(x, br, n0).unfold(-1, taps, 1) for br in branches], dim=-1)


def fresh_design(x, d, branches: Sequence[FreshBranch], taps: int = 16,
                 delay: int | None = None, ridge: float = 1e-4, n0: int = 0,
                 device=None) -> FreshFilter:
    """LS design: min_w ||PHI w - d||^2 over a training block x [N] with the
    target waveform d [N] (sample-aligned with x; a non-tensor goes to x's
    device). delay centres the window (default taps//2). Normal equations:
    Gram [BT, BT] and cross [BT] (TF32 off), ridge-regularised by `ridge`
    times the mean diagonal, then one complex solve."""
    if delay is None:
        delay = taps // 2
    x = as_tensor_on(x, device, CF32)
    d = as_tensor_on(d, x.device, CF32)
    phi = fresh_frames(x, branches, taps, n0)
    pin_f32(phi)
    nv = phi.shape[0]
    dv = d[taps - 1 - delay: taps - 1 - delay + nv]
    ph = torch.conj(phi.T)
    gram = ph @ phi
    gram = gram + (ridge * torch.diagonal(gram).sum().real / gram.shape[0]) * torch.eye(
        gram.shape[0], dtype=gram.dtype, device=gram.device)
    w = torch.linalg.solve(gram, ph @ dv)
    return FreshFilter(weights=w, branches=tuple(branches), taps=taps, delay=delay)


def fresh_apply(f: FreshFilter, x, n0: int = 0, device=None) -> torch.Tensor:
    """Filter a block: y [N - taps + 1], where y[n] estimates
    d[n0 + n + taps - 1 - delay]. n0 must be the global index of x[0] so the
    rotators stay phase-continuous with the design. The regressors are
    formed APPLY_ROWS rows at a time (each chunk with its own n0)."""
    x = as_tensor_on(x, device, CF32)
    w = f.weights.to(x.device)
    pin_f32(x)
    nv = x.shape[-1] - f.taps + 1
    out = []
    for r0 in range(0, nv, APPLY_ROWS):
        r1 = min(r0 + APPLY_ROWS, nv)
        out.append(fresh_frames(x[r0: r1 + f.taps - 1], f.branches, f.taps, n0 + r0) @ w)
    return torch.cat(out)
