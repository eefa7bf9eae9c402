"""FRESH filtering in plane form (counterpart of
``srcdsp_tpu/ops/fresh_planes.py``): one framed banded matmul per
conj-group plus a per-(row, branch) phasor epilogue.

The fold: with frames fr[J, r] = x[n0 + J*s + r] and a branch rotator
rot_b[m] = e^{j 2 pi alpha_b m}, the branch output is

    y_b[J*s + k] = rot_b[n0 + J*s] * (fr @ G_b)[J, k],
    G_b[r, k]    = w_b[r - k] * rot_b[r]           (banded, r-k in [0,T))

so the tap window and the intra-row rotation live in a constant matrix,
leaving a per-(row, branch) phasor. Branches concatenate along columns into
one [span, B*s] operand per conj-group: four real float32 matmuls per group
(TF32 off) and one phasor combine. The phases split exactly in u32 word
arithmetic (rot[n0 + J*s + r] = rot[n0 + J*s] * rot[r]): the row word
w0 + J*dw is formed in int64 masked to 32 bits, then converted to float32
(the reference's u32 -> f32). The frames are `kernels.mixfir_preframed.
frame_planes`, the port's counterpart of the plain-jnp framer the reference
imports.
"""

from __future__ import annotations

import numpy as np
import torch

from srcdsp_tpu_torch.chains.css_planes import _is_default
from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.kernels.mixfir_preframed import frame_planes
from srcdsp_tpu_torch.ops.fir import pin_f32
from srcdsp_tpu_torch.ops.fresh import FreshFilter
from srcdsp_tpu_torch.ops.nco import MASK32, TWO_PI, _INV_SCALE, freq_to_word
from srcdsp_tpu_torch.types import F32

__all__ = ["make_fresh_planes"]


def make_fresh_planes(f: FreshFilter, stride: int = 128, precision="highest", device=None):
    """Bake a FreshFilter into the framed matmul apply on `device` (None =
    the card):

        fn(xr, xi, n0) -> (yr, yi)   planes [1, N + hist] -> [1, N]

    with N % stride == 0 and hist = padded_taps - 1 lookahead samples
    appended (y[n] needs x[n .. n+taps-1]); hist must divide stride (the
    taps are zero-padded up to that geometry). n0 (an int) is the global
    index of x[0]; output n estimates d[n0 + n + taps - 1 - delay], as
    `fresh_apply`. `precision` keeps the reference's signature and takes only
    its two values ("highest" or "default"; both float32 here); any other
    value raises."""
    _is_default(precision)
    if f.taps > stride + 1:
        raise ValueError(f"taps {f.taps} cannot pad to a divisor of "
                         f"stride {stride}; raise stride")
    dev = resolve(device)
    tp = f.taps
    while (tp - 1) <= 0 or stride % (tp - 1):
        tp += 1
    hist = tp - 1
    span = stride + hist
    nb = len(f.branches)
    w = np.zeros((nb, tp), np.complex64)
    w[:, : f.taps] = np.asarray(torch.as_tensor(f.weights).cpu()).reshape(nb, f.taps)
    dwords = np.asarray([int(freq_to_word(br.alpha)) & MASK32 for br in f.branches], np.uint64)
    groups = {}
    for flag in (False, True):
        idx = [b for b in range(nb) if f.branches[b].conj == flag]
        if not idx:
            continue
        g = np.zeros((span, len(idx) * stride), np.complex64)
        for j, b in enumerate(idx):
            # intra-row rotator at local index r (u32-exact phase split)
            ph = 2 * np.pi * ((dwords[b] * np.arange(span, dtype=np.uint64))
                              % (1 << 32)).astype(np.float64) / (1 << 32)
            rot = np.exp(1j * ph)
            t = np.arange(tp)
            for k in range(stride):
                g[k + t, j * stride + k] = w[b] * rot[k + t]
        dw = torch.as_tensor([(int(dwords[b]) * stride) & MASK32 for b in idx],
                             dtype=torch.int64, device=dev)
        groups[flag] = (idx, torch.as_tensor(g.real.astype(np.float32), device=dev),
                        torch.as_tensor(g.imag.astype(np.float32), device=dev), dw)
    scale = np.float32(TWO_PI * _INV_SCALE)

    def fn(xr: torch.Tensor, xi: torch.Tensor, n0: int = 0):
        n = xr.shape[-1] - hist
        if n % stride:
            raise ValueError(f"N={n} not a multiple of stride {stride}")
        pin_f32(xr)
        nt = n // stride
        fr_r = frame_planes(xr, stride, span).reshape(nt, span)
        fr_i = frame_planes(xi, stride, span).reshape(nt, span)
        row = torch.arange(nt, dtype=torch.int64, device=xr.device)[:, None]
        accr = torch.zeros((nt, stride), dtype=F32, device=xr.device)
        acci = torch.zeros((nt, stride), dtype=F32, device=xr.device)
        for flag, (idx, gr, gi, dw) in groups.items():
            sgn = -1.0 if flag else 1.0
            mr = fr_r @ gr - sgn * (fr_i @ gi)
            mi = fr_r @ gi + sgn * (fr_i @ gr)
            mr = mr.reshape(nt, len(idx), stride)
            mi = mi.reshape(nt, len(idx), stride)
            # per-(row, branch) phasor at global index n0 + J*stride
            w0 = torch.as_tensor([(int(n0) * int(dwords[b])) & MASK32 for b in idx],
                                 dtype=torch.int64, device=xr.device)[None, :]
            ph = ((w0 + row * dw[None, :]) & MASK32).to(F32) * scale
            c, s = torch.cos(ph)[:, :, None], torch.sin(ph)[:, :, None]
            accr = accr + (mr * c - mi * s).sum(dim=1)
            acci = acci + (mr * s + mi * c).sum(dim=1)
        return accr.reshape(1, n), acci.reshape(1, n)

    fn.hist = hist          # callers size input as [1, N + fn.hist]
    fn.stride = stride
    fn.taps_padded = tp
    return fn
