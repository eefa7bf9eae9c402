"""Adaptive channel equalizers: block LMS (trained / decision-directed),
blind CMA, RLS and a decision-feedback equalizer (counterpart of
``srcdsp_tpu/chains/equalizer.py``).

Block-adaptive filtering: each step processes B output samples as one [B, L]
frame matrix: y = X w (one product), error e per mode, gradient X^H e (a
second product), w <- w + (mu/B) X^H e. The once-per-block weight update is
carried by a Python loop over blocks (the reference's `lax.scan`), over any
leading channel dims. The fractionally-spaced variant (sps > 1 input samples
per output) folds the stride into the framing.

Modes: 'train' (e = d - y against known symbols), 'dd' (e = slice(y) - y on
the PSK constellation), 'cma' (e = y (R2 - |y|^2), Godard's blind error).

RLS and the DFE are per-symbol recurrences (the reference's per-symbol
scans): Python loops of [L] / [L, L] torch ops on the input's device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.ops.fir import pin_f32
from srcdsp_tpu_torch.types import CF32

__all__ = ["EqState", "eq_init", "lms_equalize", "cma_equalize", "psk_slicer",
           "make_eq_frames", "RlsState", "rls_init", "rls_equalize",
           "DfeState", "dfe_init", "dfe_equalize"]


class EqState(NamedTuple):
    w: torch.Tensor       # [..., L] complex taps
    tail: torch.Tensor    # [..., L-1] carried input samples (sample rate)


def _spike(ntaps: int, shape: tuple, center_spike: bool, device) -> torch.Tensor:
    w = torch.zeros((*shape, ntaps), dtype=CF32, device=device)
    if center_spike:
        w[..., ntaps // 2] = 1.0
    return w


def eq_init(ntaps: int, center_spike: bool = True, channel_shape: tuple = (),
            device=None) -> EqState:
    """center_spike=True -> w = delta at the center tap. On `device` (None =
    the card)."""
    device = resolve(device)
    return EqState(w=_spike(ntaps, channel_shape, center_spike, device),
                   tail=torch.zeros((*channel_shape, ntaps - 1), dtype=CF32, device=device))


def make_eq_frames(xin: torch.Tensor, ntaps: int, sps: int) -> torch.Tensor:
    """[..., B*sps + L - 1] -> [..., B, L] rows x_n = [x[n*sps+L-1], ...,
    x[n*sps]] (reversed windows, so y = X @ w is the usual delay-line dot)."""
    b = (xin.shape[-1] - (ntaps - 1)) // sps
    return xin.unfold(-1, ntaps, sps)[..., :b, :].flip(-1)


def psk_slicer(y: torch.Tensor, order: int, offset: float = 0.0) -> torch.Tensor:
    """Nearest M-PSK point exp(j(offset + 2 pi k/M)) of each sample
    (rounding half to even, as jnp.round)."""
    ang = torch.angle(y) - offset
    step = 2.0 * np.pi / order
    q = torch.round(ang / step) * step + offset
    return torch.exp(1j * q).to(CF32)


def _block_equalize(x: torch.Tensor, d: torch.Tensor | None, state: EqState, mu: float,
                    block: int, sps: int, mode: str, order: int, r2: float,
                    offset: float = 0.0):
    ntaps = state.w.shape[-1]
    s = x.shape[-1]
    if s % (block * sps) != 0:
        raise ValueError(f"signal length {s} must divide into blocks of {block * sps} "
                         f"input samples")
    nb = s // (block * sps)
    pin_f32(x)
    w, tail = state.w, state.tail
    ys, mses = [], []
    for k in range(nb):
        xin = torch.cat([tail, x[..., k * block * sps:(k + 1) * block * sps]], dim=-1)
        frames = make_eq_frames(xin, ntaps, sps)                  # [..., B, L]
        y = torch.einsum("...bl,...l->...b", frames, w)
        if mode == "train":
            e = d[..., k * block:(k + 1) * block] - y
        elif mode == "dd":
            e = psk_slicer(y, order, offset) - y
        else:
            e = y * (np.float32(r2) - (y.real ** 2 + y.imag ** 2))
        grad = torch.einsum("...bl,...b->...l", torch.conj(frames), e)
        w = (w + (mu / block) * grad).to(CF32)
        tail = xin[..., xin.shape[-1] - (ntaps - 1):]
        ys.append(y)
        mses.append(torch.mean(torch.abs(e) ** 2, dim=-1))
    return EqState(w=w, tail=tail), torch.cat(ys, dim=-1), torch.stack(mses, dim=-1)


def _delayed(d: torch.Tensor, dly: int) -> torch.Tensor:
    """d delayed by dly symbols, zero-filled."""
    if dly <= 0:
        return d
    z = torch.zeros((*d.shape[:-1], dly), dtype=d.dtype, device=d.device)
    return torch.cat([z, d[..., :-dly]], dim=-1)


def lms_equalize(x: torch.Tensor, state: EqState, mu: float, block: int = 64, sps: int = 1,
                 d: torch.Tensor | None = None, order: int = 4, delay: int | None = None,
                 offset: float = 0.0) -> tuple[EqState, torch.Tensor, torch.Tensor]:
    """Block-LMS equalize. x: [..., B_total*sps] received samples.

    With `d` (known symbols [..., B_total]): training mode; `delay` is the
    decision delay in symbols (default ntaps//(2*sps)), applied to d
    internally. Without `d`: decision-directed on the `order`-PSK
    constellation at phase `offset`. Returns (state, y [..., B_total], mse
    per block [..., nb]). To split one capture across calls, pre-shift d
    once and pass delay=0."""
    mode = "train" if d is not None else "dd"
    if d is not None:
        dly = state.w.shape[-1] // (2 * sps) if delay is None else int(delay)
        d = _delayed(d.to(CF32), dly)
    return _block_equalize(x, d, state, mu, block, sps, mode, order, 0.0, offset)


def cma_equalize(x: torch.Tensor, state: EqState, mu: float, block: int = 64, sps: int = 1,
                 r2: float = 1.0) -> tuple[EqState, torch.Tensor, torch.Tensor]:
    """Blind constant-modulus equalize (Godard p=2). r2 = E|s|^4 / E|s|^2
    (1.0 for PSK). The output carries an unknown phase rotation."""
    return _block_equalize(x, None, state, mu, block, sps, "cma", 4, r2)


class RlsState(NamedTuple):
    w: torch.Tensor       # [L] complex taps
    p: torch.Tensor       # [L, L] inverse correlation matrix
    tail: torch.Tensor    # [L-1] carried input samples


def rls_init(ntaps: int, delta: float = 0.1, center_spike: bool = True,
             device=None) -> RlsState:
    """P0 = I/delta (small delta = weak prior = fast initial adaptation). On
    `device` (None = the card)."""
    device = resolve(device)
    return RlsState(w=_spike(ntaps, (), center_spike, device),
                    p=torch.eye(ntaps, dtype=CF32, device=device) / np.float32(delta),
                    tail=torch.zeros((ntaps - 1,), dtype=CF32, device=device))


def _targets(d, nframes: int, ntaps: int, sps: int, delay, device):
    """The training targets delayed as lms_equalize delays them, or None."""
    if d is None:
        return None
    dly = ntaps // (2 * sps) if delay is None else int(delay)
    return _delayed(d.to(CF32).to(device), dly)[:nframes]


def rls_equalize(x: torch.Tensor, state: RlsState, lam: float = 0.99, sps: int = 1,
                 d: torch.Tensor | None = None, order: int = 4, delay: int | None = None,
                 offset: float = 0.0) -> tuple[RlsState, torch.Tensor, torch.Tensor]:
    """Exponentially-weighted recursive least squares, one symbol a step
    (O(L^2) work a symbol; use it to acquire on short preambles). Same
    conventions as lms_equalize. Returns (state, y, |e|^2 per symbol).

    The per-symbol step is the reference's: y = sum(u w), pu = P conj(u),
    g = pu / (lam + Re(u . pu)), w += g e, P = (P - g (u P)) / lam, then
    P made Hermitian against float32 drift."""
    ntaps = state.w.shape[-1]
    pin_f32(x)
    xin = torch.cat([state.tail, x.to(CF32)], dim=-1)
    frames = make_eq_frames(xin, ntaps, sps)            # [B, L]
    db = _targets(d, frames.shape[0], ntaps, sps, delay, x.device)
    lam32 = np.float32(lam)
    w, p = state.w, state.p
    ys, errs = [], []
    for n in range(frames.shape[0]):
        u = frames[n]
        y = torch.sum(u * w)
        target = db[n] if db is not None else psk_slicer(y, order, offset)
        e = target - y
        pu = p @ torch.conj(u)                          # [L]
        denom = lam32 + torch.sum(u * pu).real
        g = pu / denom.to(CF32)
        w = (w + g * e).to(CF32)
        p2 = (p - torch.outer(g, u @ p)) / lam32
        p = (0.5 * (p2 + torch.conj(p2.T))).to(CF32)
        ys.append(y)
        errs.append(torch.abs(e) ** 2)
    tail = xin[..., xin.shape[-1] - (ntaps - 1):]
    return RlsState(w=w, p=p, tail=tail), torch.stack(ys), torch.stack(errs)


class DfeState(NamedTuple):
    ff: torch.Tensor      # [Lf] feedforward taps
    fb: torch.Tensor      # [Lb] feedback taps (on past decisions)
    tail: torch.Tensor    # [Lf-1] carried input samples
    past: torch.Tensor    # [Lb] carried past decisions (newest first)


def dfe_init(nff: int, nfb: int, center_spike: bool = True, device=None) -> DfeState:
    """Zero feedback, center-spike feedforward, on `device` (None = the card)."""
    device = resolve(device)
    return DfeState(ff=_spike(nff, (), center_spike, device),
                    fb=torch.zeros((nfb,), dtype=CF32, device=device),
                    tail=torch.zeros((nff - 1,), dtype=CF32, device=device),
                    past=torch.zeros((nfb,), dtype=CF32, device=device))


def dfe_equalize(x: torch.Tensor, state: DfeState, mu: float, sps: int = 1,
                 d: torch.Tensor | None = None, order: int = 4, delay: int | None = None,
                 offset: float = 0.0) -> tuple[DfeState, torch.Tensor, torch.Tensor]:
    """Decision-feedback equalizer (LMS-adapted): y_n = ff^T u_n - fb^T
    dec_{n-1..n-Lb}; the feedback path cancels postcursor ISI with decided
    symbols. One symbol a step (the decision recurrence). Same training
    conventions as lms_equalize. Returns (state, y [Nsym], |e|^2 per
    symbol)."""
    nff = state.ff.shape[-1]
    if x.shape[-1] % sps != 0:
        raise ValueError(f"input length {x.shape[-1]} not divisible by sps {sps} "
                         f"(streaming would slip symbol timing)")
    xin = torch.cat([state.tail, x.to(CF32)], dim=-1)
    frames = make_eq_frames(xin, nff, sps)              # [B, Lf]
    db = _targets(d, frames.shape[0], nff, sps, delay, x.device)
    ff, fb, past = state.ff, state.fb, state.past
    ys, errs = [], []
    for n in range(frames.shape[0]):
        u = frames[n]
        y = torch.sum(u * ff) - torch.sum(past * fb)
        target = db[n] if db is not None else psk_slicer(y, order, offset)
        e = target - y
        ff = (ff + mu * e * torch.conj(u)).to(CF32)
        fb = (fb - mu * e * torch.conj(past)).to(CF32)
        past = torch.cat([target[None], past[:-1]]).to(CF32)
        ys.append(y)
        errs.append(torch.abs(e) ** 2)
    tail = xin[..., xin.shape[-1] - (nff - 1):]
    return DfeState(ff=ff, fb=fb, tail=tail, past=past), torch.stack(ys), torch.stack(errs)
