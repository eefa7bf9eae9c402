"""MIMO spatial-multiplexing detection (counterpart of ``srcdsp_tpu/mimo.py``):
ZF, MMSE and exact ML detectors for an Nt x Nr flat channel.

- ZF and MMSE are batched small linear algebra on the received block's
  device: one [Nr, Nt] pseudo-inverse or regularized solve applied to all
  symbols at once (TF32 off).
- ML enumerates the candidate lattice (M^Nt transmit vectors) once into a
  [C, Nr] expected-receive table; detection is argmin |y - Hs|^2 =
  argmin (|Hs|^2 - 2 Re<y, Hs>) over the [N, C] cross product, then a
  gather of the winners' indices. The real part of the cross is taken as
  two real float32 matmuls (Re y * Re Hs + Im y * Im Hs), in row chunks of
  at most ML_CROSS elements, so the [N, C] matrix is float32 and bounded
  (4x4 16-QAM: C = 65,536). `torch.argmin` returns the first minimum, as
  `jnp.argmin`.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from srcdsp_tpu_torch.device import as_tensor_on
from srcdsp_tpu_torch.ops.fir import pin_f32
from srcdsp_tpu_torch.types import CF32

__all__ = ["zf_detect", "mmse_detect", "make_ml_lattice", "ml_detect"]

# elements of the [rows, C] float32 cross formed at once by ml_detect (512 MB)
ML_CROSS = 1 << 27


def zf_detect(h, y, device=None) -> torch.Tensor:
    """Zero-forcing: x_hat = pinv(H) y. h: [Nr, Nt]; y: [Nr, N] -> [Nt, N]
    (a tensor stays on its device, anything else goes to `device`, None =
    the card; h follows y)."""
    y = as_tensor_on(y, device, CF32)
    h = torch.as_tensor(h, dtype=CF32, device=y.device)
    pin_f32(y)
    return torch.linalg.pinv(h) @ y


def mmse_detect(h, y, snr: float, device=None) -> torch.Tensor:
    """LMMSE: (H^H H + Nt/snr I)^-1 H^H y (snr = per-receive-antenna symbol
    SNR, linear)."""
    y = as_tensor_on(y, device, CF32)
    h = torch.as_tensor(h, dtype=CF32, device=y.device)
    pin_f32(y)
    nt = h.shape[-1]
    hh = torch.conj(h.T) @ h + (nt / snr) * torch.eye(nt, dtype=CF32, device=y.device)
    return torch.linalg.solve(hh, torch.conj(h.T) @ y)


def make_ml_lattice(points: np.ndarray, nt: int) -> tuple[np.ndarray, np.ndarray]:
    """(candidates [C, Nt] complex, indices [C, Nt] int) — every transmit
    vector over the constellation, enumerated on the host once."""
    pts = np.asarray(points)
    idx = np.asarray(list(itertools.product(range(pts.size), repeat=nt)), np.int64)
    return pts[idx], idx


def ml_detect(h, y, cands: np.ndarray, cand_idx: np.ndarray, device=None) -> torch.Tensor:
    """Exact ML: argmin_s |y - H s|^2 over the full lattice.

    h: [Nr, Nt]; y: [Nr, N]; cands/cand_idx from make_ml_lattice. Returns
    [Nt, N] int32 constellation indices per stream, on y's device."""
    y = as_tensor_on(y, device, CF32)
    dev = y.device
    h = torch.as_tensor(h, dtype=CF32, device=dev)
    pin_f32(y)
    exp = torch.as_tensor(np.asarray(cands).astype(np.complex64), device=dev) @ h.T  # [C, Nr]
    e2 = (exp.real ** 2 + exp.imag ** 2).sum(dim=-1)                               # [C]
    er, ei = exp.real.T.contiguous(), exp.imag.T.contiguous()                       # [Nr, C]
    yt = y.T
    yr, yi = yt.real.contiguous(), yt.imag.contiguous()                             # [N, Nr]
    rows = max(1, ML_CROSS // exp.shape[0])
    best = []
    for r0 in range(0, yt.shape[0], rows):
        cross = yr[r0: r0 + rows] @ er
        cross.addmm_(yi[r0: r0 + rows], ei)                                        # Re<y, Hs>
        best.append(torch.argmin(cross.mul_(-2.0).add_(e2[None, :]), dim=-1))
    idx = torch.as_tensor(np.asarray(cand_idx).astype(np.int32), device=dev)
    return idx[torch.cat(best)].T
