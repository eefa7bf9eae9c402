"""OFDM receive path in plane form (counterpart of
``srcdsp_tpu/chains/ofdm_planes.py``): the serving tier of the OFDM family.

- CP removal: one reshape + slice;
- the DFT restricted to the active bins: the DFT matrix keeps only the
  columns of used bins, so the transform is one [S, nfft] x [nfft, n_active]
  matmul pair in float32 (TF32 kept off, as the reference's HIGHEST
  precision keeps its matmuls in f32);
- one-tap EQ from the n_pilot pilot symbols, inverted with plane arithmetic
  (multiply by the conjugate over the power);
- decision-directed common phase with no table lookup: the plane slicer's
  level index gives the nearest point's coordinate, so the per-symbol LS
  complex gain is two reductions;
- Gray indices from integer ops.
"""

from __future__ import annotations

import numpy as np
import torch

from srcdsp_tpu_torch.chains.ofdm import OfdmSpec, sym_len
from srcdsp_tpu_torch.chains.qam import qam_slice_planes
from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.ops.fir import pin_f32

__all__ = ["make_ofdm_rx_planes"]


def cmatmul(tr: torch.Tensor, ti: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(tr + j ti) @ (wr + j wi) as four float32 matmuls."""
    pin_f32(tr)
    return tr @ wr - ti @ wi, tr @ wi + ti @ wr


def make_ofdm_rx_planes(spec: OfdmSpec, n_pilot: int = 1, device=None):
    """Build the plane-form receiver for a fixed spec.

    Returns fn(yr, yi, pr, pi) with yr/yi [C, K] aligned sample planes (the
    first n_pilot symbols the known pilot, repeated; K % (nfft+cp) == 0) and
    pr/pi [n_active] the pilot's constellation planes -> (idx [C, S,
    n_active] int32, (zr, zi) equalized and derotated soft planes), S =
    K/(nfft+cp) - n_pilot data symbols. n_pilot > 1 averages the per-bin LS
    estimates. The reference's `precision` option has no counterpart: the
    matmuls run in float32.
    """
    device = resolve(device)
    nfft, cp = spec.nfft, spec.cp
    act = np.asarray(spec.active)
    na = act.size
    ll = sym_len(spec)
    # DFT restricted to the active bins, pre-scaled by 1/sqrt(nfft)
    w = np.exp(-2j * np.pi * np.outer(np.arange(nfft), act) / nfft)
    w = (w / np.sqrt(nfft)).astype(np.complex64)
    wr = torch.as_tensor(w.real.copy(), device=device)
    wi = torch.as_tensor(w.imag.copy(), device=device)
    eps = np.float32(1e-12)

    def fn(yr, yi, pr, pi):
        c, k = yr.shape
        s_tot = k // ll
        tr = yr[:, : s_tot * ll].reshape(c * s_tot, ll)[:, cp:]
        ti = yi[:, : s_tot * ll].reshape(c * s_tot, ll)[:, cp:]
        fr, fi = cmatmul(tr, ti, wr, wi)
        fr = fr.reshape(c, s_tot, na)
        fi = fi.reshape(c, s_tot, na)

        # one-tap EQ from the pilot symbol(s): h = mean(f0)/p, soft = f/h
        f0r = torch.mean(fr[:, :n_pilot], dim=1, keepdim=True)
        f0i = torch.mean(fi[:, :n_pilot], dim=1, keepdim=True)
        pd = pr * pr + pi * pi + eps
        hr = (f0r * pr + f0i * pi) / pd
        hi = (f0i * pr - f0r * pi) / pd
        hd = hr * hr + hi * hi + eps
        dr, di = fr[:, n_pilot:], fi[:, n_pilot:]
        sr = (dr * hr + di * hi) / hd
        si = (di * hr - dr * hi) / hd

        # nearest point per axis (the level index is the coordinate)
        _, (shr, shi) = qam_slice_planes(sr, si, spec.order)

        # per-symbol DD common phase: g = sum(soft * conj(s_hat)) / sum|s_hat|^2
        num_r = torch.sum(sr * shr + si * shi, dim=-1, keepdim=True)
        num_i = torch.sum(si * shr - sr * shi, dim=-1, keepdim=True)
        den = torch.sum(shr * shr + shi * shi, dim=-1, keepdim=True) + eps
        gr = num_r / den
        gi = num_i / den
        ga = torch.sqrt(gr * gr + gi * gi) + eps
        zr = (sr * gr + si * gi) / ga
        zi = (si * gr - sr * gi) / ga

        idx, _ = qam_slice_planes(zr, zi, spec.order)
        return idx, (zr, zi)

    return fn
