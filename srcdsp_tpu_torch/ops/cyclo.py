"""Cyclostationary spectral correlation by the FFT Accumulation Method
(counterpart of ``srcdsp_tpu/ops/cyclo.py``).

FAM: one strided-frame batched FFT (the channelizer), a closed-form
down-conversion phase ramp, one elementwise outer product over channel pairs
([Np, Np, P], complex64: 512 MB at Np 256, P 1024, the frame index last) and
a second batched FFT over the frame index, all on the input's device. The (f, alpha) grids come
from the reference's float64 host vectors: f on the host, alpha's [Np, Np, P]
sum of them on the device in float64 (the same IEEE operations, so the same
float32 values after the cast). `cycle_profile`'s per-bin maximum is one `scatter_reduce` (amax) on
the device: a maximum does not depend on order, so it equals the
reference's `np.maximum.at`. Sizes are the textbook ones (Np channels x P
frames -> alpha resolution 1/(P*L) with L = Np/4 hop).

Reference: Roberts, Brown & Loomis, "Computationally efficient algorithms for
cyclic spectral analysis" (IEEE SP Mag 1991); fs = 1.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from srcdsp_tpu_torch.device import as_tensor_on
from srcdsp_tpu_torch.types import CF32, F32


class ScfResult(NamedTuple):
    """Dense spectral-correlation estimate on the (f, alpha) bi-frequency
    grid; the grid is the FAM diamond (not rectangular)."""

    scf: torch.Tensor     # [Np, Np, P] complex: S[k1, k2, q]
    freq: torch.Tensor    # [Np, Np] spectral frequency f per (k1, k2)
    alpha: torch.Tensor   # [Np, Np, P] cycle frequency per (k1, k2, q)


def _frames(x: torch.Tensor, np_: int, hop: int, p: int) -> torch.Tensor:
    """[P, Np] strided frames: hop-sized rows concatenated when hop | Np,
    else one gather of a [P, Np] index grid."""
    need = (p - 1) * hop + np_
    if x.shape[-1] < need:
        raise ValueError(f"need {need} samples for Np={np_}, P={p}, "
                         f"hop={hop}; got {x.shape[-1]}")
    if np_ % hop == 0:
        k = np_ // hop
        rows = x[..., : (p + k - 1) * hop].reshape(*x.shape[:-1], p + k - 1, hop)
        return torch.cat([rows[..., j: j + p, :] for j in range(k)], dim=-1)
    idx = np.arange(p)[:, None] * hop + np.arange(np_)[None, :]
    return x[..., torch.as_tensor(idx, device=x.device)]


@functools.lru_cache(maxsize=8)
def _fam_grids(np_: int, p: int, conj: bool, window: str):
    """The host constants of one FAM geometry, as the reference forms them:
    the window (float32), the down-conversion phasors [P, Np] (complex64),
    the freq grid (float32) and the float64 vectors alpha0 [Np, Np] and q [P]
    of the alpha grid."""
    ell = np_ // 4
    if window == "hamming":
        w = np.hamming(np_)
    elif window == "hann":
        w = np.hanning(np_)
    else:
        w = np.ones(np_)
    w = (w / np.sqrt(np.sum(w ** 2) / np_)).astype(np.float32)
    # down-convert channel k to baseband: e^{-j 2 pi kc (m L) / Np}
    kc = np.fft.fftshift(np.fft.fftfreq(np_)) * np_
    ph = np.exp(-2j * np.pi * np.outer(np.arange(p) * ell, kc) / np_).astype(np.complex64)
    f1 = kc / np_
    q = np.fft.fftshift(np.fft.fftfreq(p)) / ell
    if conj:
        freq = (f1[:, None] - f1[None, :]) / 2.0
        alpha0 = f1[:, None] + f1[None, :]
    else:
        freq = (f1[:, None] + f1[None, :]) / 2.0
        alpha0 = f1[:, None] - f1[None, :]
    return w, ph, freq.astype(np.float32), alpha0, q


def fam_scf(x, np_: int = 64, p: int = 128, conj: bool = False,
            window: str = "hamming", device=None) -> ScfResult:
    """FFT Accumulation Method estimate of the spectral correlation function
    of x ([N] complex, fs = 1; a tensor stays on its device, anything else
    goes to `device`, None = the card).

    np_: spectral channels (frequency resolution 1/np_); p: frames
    accumulated (cycle resolution 1/(p*L), L = np_//4); conj=False: the
    non-conjugate SCF (baud-rate features); conj=True: the conjugate SCF
    (2 f_c carrier features, the BPSK-vs-QPSK discriminator). Needs
    N >= (p-1)*np_//4 + np_ samples.
    """
    x = as_tensor_on(x, device)
    dev = x.device
    w, ph, freq, alpha0, q = _fam_grids(np_, p, conj, window)
    fr = _frames(x.to(CF32), np_, np_ // 4, p) * torch.as_tensor(w, device=dev)[None, :]
    cx = torch.fft.fftshift(torch.fft.fft(fr, dim=-1), dim=-1)          # [P, Np]
    cx = cx * torch.as_tensor(ph, device=dev)

    # the products with the frame index last ([Np, Np, P], the reference's layout
    # after its moveaxis), so the second FFT runs over contiguous rows
    ct = cx.T.contiguous()                                             # [Np, P]
    other = ct if conj else torch.conj(ct)
    d = ct[:, None, :] * other[None, :, :]                             # [Np, Np, P]
    s = torch.fft.fft(d, dim=-1)
    del d
    s = torch.fft.fftshift(s, dim=-1)
    s /= p

    # alpha0 + q in float64, then float32: the reference's host sum, taken on the
    # device (the same IEEE operations) 16 rows of k1 at a time, so neither the
    # host nor the card holds the [Np, Np, P] float64 grid
    a0 = torch.as_tensor(alpha0, device=dev)
    qd = torch.as_tensor(q, device=dev)
    alpha = torch.cat([(a0[r: r + 16, :, None] + qd[None, None, :]).to(F32)
                       for r in range(0, np_, 16)])
    return ScfResult(scf=s, freq=torch.tensor(freq, device=dev), alpha=alpha)


def cycle_profile(res: ScfResult, nbins: int = 512,
                  normalize: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Alpha-domain detection statistic: max |SCF| over f per alpha bin, on
    the SCF's device. Alpha wraps into [-0.5, 0.5) (cyclic for a complex
    signal at fs = 1) before binning into `nbins` uniform bins;
    normalize=True divides by the alpha = 0 peak (the PSD peak), taken over
    the bins on both sides of alpha = 0. Returns (alpha_axis [nbins],
    profile [nbins]) float32."""
    dev = res.scf.device
    prof = torch.zeros(nbins, dtype=F32, device=dev)
    # 16 rows of k1 at a time (a maximum does not depend on the order), so no
    # full-grid temporaries are held
    for r in range(0, res.scf.shape[0], 16):
        a = torch.remainder(res.alpha[r: r + 16].reshape(-1) + 0.5, 1.0) - 0.5
        mag = torch.abs(res.scf[r: r + 16]).reshape(-1).to(F32)
        bins = torch.clamp(((a + 0.5) * nbins).to(torch.int64), 0, nbins - 1)
        prof = prof.scatter_reduce(0, bins, mag, "amax")
    axis = (np.arange(nbins) + 0.5) * (1.0 / nbins) - 0.5
    if normalize:
        z0 = int(np.abs(axis).argmin())
        z = prof[max(z0 - 1, 0): z0 + 2].max()
        prof = prof / torch.clamp(z, min=1e-30)
    return torch.as_tensor(axis.astype(np.float32), device=dev), prof


def detect_cycles(res: ScfResult, nbins: int = 512, guard: int = 3,
                  thresh: float = 0.35) -> list[tuple[float, float]]:
    """Peak-pick the normalized cycle profile away from alpha = 0 (host,
    after one copy of the profile): [(alpha, strength)] for local maxima at
    or above `thresh` of the PSD peak, +-guard bins around alpha = 0 left
    out, strongest first. The noise floor of the max statistic is about
    4.4/sqrt(P) of the PSD peak."""
    axis, prof = cycle_profile(res, nbins=nbins, normalize=True)
    axis = axis.cpu().numpy()
    prof = prof.cpu().numpy().copy()
    z = int(np.abs(axis).argmin())
    prof[max(z - guard, 0): z + guard + 1] = 0.0
    out = []
    for i in range(1, nbins - 1):
        if prof[i] >= thresh and prof[i] >= prof[i - 1] and prof[i] >= prof[i + 1]:
            out.append((float(axis[i]), float(prof[i])))
    out.sort(key=lambda t: -t[1])
    return out
