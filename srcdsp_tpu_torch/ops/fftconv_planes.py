"""Plane-form overlap-save FFT convolution (counterpart of
``srcdsp_tpu/ops/fftconv_planes.py``).

The overlapped frame matrix is built without a gather: when hop divides
fft_size, frame k's samples [k*hop, k*hop + F) are F/hop consecutive rows of
the [K', hop] reshape, so the frame matrix is a concat of F/hop row-shifted
slices. The transform is the four-step matrix FFT (``ops.fft_planes``); the
inverse runs through the conjugation identity ifft(X) = conj(fft(conj(X)))/N.

Semantics: the causal FIR from rest of ``ops.fftconv`` (same frames, same
frequency response). hop is a power-of-two divisor of fft_size, 2048 at 1024
taps and fft 4096 (``ops.fftconv`` takes 3073 there).
"""

from __future__ import annotations

import numpy as np
import torch

from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.ops.fft_planes import make_fft_planes


def make_fftconv_planes(taps, fft_size: int, hop: int | None = None, precision=None,
                        device=None):
    """Build the plane-form overlap-save filter.

    Returns (fn, hop) where fn: (xr, xi) [HIST + N] planes -> [N] planes,
    HIST = fft_size - hop (zeros at stream start, the carried tail when
    streaming), N % hop == 0. hop defaults to the largest power-of-two
    divisor of fft_size that is <= fft_size - num_taps + 1. `precision` is
    accepted for the JAX signature and changes nothing (full float32).
    """
    taps = np.asarray(taps)
    t = len(taps)
    max_hop = fft_size - (t - 1)
    if hop is None:
        hop = 1
        while hop * 2 <= max_hop and fft_size % (hop * 2) == 0:
            hop *= 2
    if not 0 < hop <= max_hop:
        raise ValueError(f"hop {hop} not in (0, {max_hop}]")
    if fft_size % hop != 0:
        raise ValueError(f"fft_size {fft_size} % hop {hop} != 0")
    overlap = fft_size - hop
    rows = fft_size // hop
    dev = resolve(device)
    hfull = np.fft.fft(np.asarray(taps, np.complex128), n=fft_size)
    hr = torch.as_tensor(hfull.real.astype(np.float32), device=dev)
    hi = torch.as_tensor(hfull.imag.astype(np.float32), device=dev)
    fft = make_fft_planes(fft_size, device=dev)
    inv_n = np.float32(1.0 / fft_size)

    def fn(xr: torch.Tensor, xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        k = (xr.shape[-1] - overlap) // hop
        # frame matrix [K, F]: `rows` row-shifted hop-blocks of the [K + rows - 1, hop] reshape
        x2r = xr.reshape(-1, hop)
        x2i = xi.reshape(-1, hop)
        fr = torch.cat([x2r[r: r + k] for r in range(rows)], dim=1)
        fi = torch.cat([x2i[r: r + k] for r in range(rows)], dim=1)
        sr, si = fft(fr, fi)
        pr = sr * hr - si * hi
        pi = sr * hi + si * hr
        tr, ti = fft(pr, -pi)                    # ifft via conj: conj(fft(conj(spec)))/F
        yr = tr * inv_n
        yi = -ti * inv_n
        return yr[:, overlap:].reshape(-1), yi[:, overlap:].reshape(-1)

    return fn, hop
