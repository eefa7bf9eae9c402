"""SC-FDE receive path in plane form (counterpart of
``srcdsp_tpu/chains/scfde_planes.py``), the sibling of ``chains.ofdm_planes``.

CP strip is a reshape + slice; the forward and inverse block DFTs are
[.., n] x [n, n] float32 matmul pairs (the inverse bakes the 1/n); the LS
estimate against the Zadoff-Chu pilot and the per-bin MMSE one-taps are
plane arithmetic. Unlike OFDM, the equalized spectrum goes back to the time
domain before slicing, and decisions are per time-domain symbol.
"""

from __future__ import annotations

import numpy as np
import torch

from srcdsp_tpu_torch.chains.ofdm_planes import cmatmul
from srcdsp_tpu_torch.chains.qam import qam_slice_planes
from srcdsp_tpu_torch.chains.scfde import ScfdeSpec
from srcdsp_tpu_torch.device import resolve

__all__ = ["make_scfde_rx_planes"]


def make_scfde_rx_planes(spec: ScfdeSpec, order: int = 4, snr: float = 100.0, device=None):
    """Build the plane-form SC-FDE receiver.

    Returns fn(yr, yi) with yr/yi [C, K] aligned planes starting at the
    pilot block's CP (K % (n+cp) == 0) -> (idx [C, S, n] int32 Gray symbol
    indices, (zr, zi) equalized time-domain soft planes), S = K/(n+cp) - 1
    data blocks. The reference's `precision` option has no counterpart: the
    matmuls run in float32.
    """
    device = resolve(device)
    n, cp = spec.n, spec.cp
    ll = n + cp
    k_ = np.arange(n)
    wf = np.exp(-2j * np.pi * np.outer(k_, k_) / n).astype(np.complex64)
    wb = (np.conj(wf) / n).astype(np.complex64)      # inverse, 1/n baked
    wfr, wfi = (torch.as_tensor(a.copy(), device=device) for a in (wf.real, wf.imag))
    wbr, wbi = (torch.as_tensor(a.copy(), device=device) for a in (wb.real, wb.imag))
    pf = np.fft.fft(spec.pilot.detach().cpu().numpy())
    # LS against the pilot as a baked multiply: h = f0 * conj(pf)/|pf|^2
    pinv = (np.conj(pf) / (np.abs(pf) ** 2 + 1e-12)).astype(np.complex64)
    pir = torch.as_tensor(pinv.real.copy(), device=device)[None, None, :]
    pii = torch.as_tensor(pinv.imag.copy(), device=device)[None, None, :]
    inv_snr = np.float32(1.0 / snr)

    def fn(yr, yi):
        c, k = yr.shape
        s_tot = k // ll
        tr = yr[:, : s_tot * ll].reshape(c * s_tot, ll)[:, cp:]
        ti = yi[:, : s_tot * ll].reshape(c * s_tot, ll)[:, cp:]
        fr, fi = cmatmul(tr, ti, wfr, wfi)
        fr = fr.reshape(c, s_tot, n)
        fi = fi.reshape(c, s_tot, n)

        f0r, f0i = fr[:, :1], fi[:, :1]
        hr = f0r * pir - f0i * pii
        hi = f0r * pii + f0i * pir
        hd = hr * hr + hi * hi + inv_snr
        # MMSE one-tap w = conj(h)/(|h|^2 + 1/snr) on the data bins
        dr, di = fr[:, 1:], fi[:, 1:]
        er = (dr * hr + di * hi) / hd
        ei = (di * hr - dr * hi) / hd

        # back to the time domain (inverse DFT matmul, 1/n baked)
        cs = er.shape[1]
        zr, zi = cmatmul(er.reshape(c * cs, n), ei.reshape(c * cs, n), wbr, wbi)
        zr = zr.reshape(c, cs, n)
        zi = zi.reshape(c, cs, n)
        idx, _ = qam_slice_planes(zr, zi, order)
        return idx, (zr, zi)

    return fn
