"""CSS demodulation in plane form (counterpart of
``srcdsp_tpu/chains/css_planes.py``): the serving tier of ``chains.css``.

The dechirp is folded into the DFT matrix,

    G = diag(conj(u)) @ W,   X = x @ G     (W = symmetric DFT matrix)

so a batch of raw symbol frames [S, N] goes to spectra in one complex
product (four real float32 matmuls), then a row-wise argmax. Above the
direct form's size the factory takes dechirp planes + the port's
``ops.fft_planes`` four-step DFT, with the reference's rule.

The JAX package computes these products as ``jnp.dot`` outside any Pallas
kernel, so here they are ``torch.matmul``; ``ops.fir.pin_f32`` turns TF32
off on the card, so every product runs in full float32: the reference's
``HIGHEST``. ``precision`` is kept for the reference's signature and takes
only its two values: ``"highest"`` and ``"default"`` (the reference's
one-pass bf16 on a TPU) run the same float32 products on this card, and
``"default"`` only changes the ``direct=None`` choice at N = 2048, as in the
reference; any other value raises. G is
built in complex128 on the host from the complex64 chirp and cast to
float32 planes, as the reference builds it.
"""

from __future__ import annotations

import numpy as np
import torch

from srcdsp_tpu_torch.chains.css import CssParams, _gray_bit_masks
from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.ops.fft_planes import make_fft_planes
from srcdsp_tpu_torch.ops.fir import pin_f32
from srcdsp_tpu_torch.types import F32

__all__ = ["make_css_demod_planes", "make_css_llr_planes"]


def _is_default(precision) -> bool:
    """True for the reference's DEFAULT precision, False for HIGHEST, given
    as a string or as anything whose str() ends in the name
    (jax.lax.Precision.DEFAULT); None is DEFAULT, as for ``jnp.dot``. Any
    other value raises: no other precision exists here."""
    name = "DEFAULT" if precision is None else str(precision).upper().rsplit(".", 1)[-1]
    if name not in ("DEFAULT", "HIGHEST"):
        raise ValueError(f"precision {precision!r}: only 'highest' and 'default' (the same "
                         f"float32 products here) are accepted")
    return name == "DEFAULT"


def _fold_planes(params: CssParams, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(Gr, Gi) [N, N] float32 of G = diag(conj(u)) @ W, built in complex128."""
    n = params.n
    k = np.arange(n)
    w = np.exp(-2j * np.pi * np.outer(k, k) / n)        # symmetric DFT
    g = np.asarray(params.downchirp)[:, None] * w        # fold dechirp in
    return (torch.as_tensor(g.real.astype(np.float32), device=device),
            torch.as_tensor(g.imag.astype(np.float32), device=device))


def _folded_spectrum(xr, xi, gr, gi) -> tuple[torch.Tensor, torch.Tensor]:
    pin_f32(xr)
    return xr @ gr - xi @ gi, xr @ gi + xi @ gr


def make_css_demod_planes(params: CssParams, precision="highest", direct: bool | None = None,
                          device=None):
    """Build the batched plane demodulator: (xr, xi) [S, N] raw symbol frames
    -> (shifts [S] int32, peak_mag2 [S] float32).

    direct: fold dechirp + DFT into one [N, N] product. None = the
    reference's rule: direct for N <= 1024, and for N = 2048 only at
    `precision` "default" (the only effect of `precision` here; see the
    module docstring). The constants live on `device` (None = the card).
    """
    n = params.n
    device = resolve(device)
    default = _is_default(precision)
    if direct is None:
        direct = n <= 1024 or (n <= 2048 and default)

    if direct:
        gr, gi = _fold_planes(params, device)

        def demod(xr: torch.Tensor, xi: torch.Tensor):
            sr, si = _folded_spectrum(xr, xi, gr, gi)
            mag2 = sr * sr + si * si                    # [S, N]
            return torch.argmax(mag2, dim=-1).to(torch.int32), torch.amax(mag2, dim=-1).to(F32)

        return demod

    fft = make_fft_planes(n, device=device)
    dc = np.asarray(params.downchirp)
    dr = torch.as_tensor(dc.real.astype(np.float32)[None, :], device=device)
    di = torch.as_tensor(dc.imag.astype(np.float32)[None, :], device=device)

    def demod(xr: torch.Tensor, xi: torch.Tensor):
        yr = xr * dr - xi * di
        yi = xr * di + xi * dr
        sr, si = fft(yr, yi)
        mag2 = sr * sr + si * si                        # [S, N]
        return torch.argmax(mag2, dim=-1).to(torch.int32), torch.amax(mag2, dim=-1).to(F32)

    return demod


def make_css_llr_planes(params: CssParams, precision="highest", device=None):
    """Soft output tier: (xr, xi) [S, N] raw symbol frames -> per-Gray-bit
    LLRs [S, sf] float32 (positive = bit 0), the plane twin of
    ``css.css_soft_llrs``: the folded dechirp-DFT product, |S|, then one
    masked max pair per bit over [sf, S, N]. `precision` is checked as on
    `make_css_demod_planes` and has no effect (float32 at both values);
    constants on `device` (None = the card)."""
    _is_default(precision)
    device = resolve(device)
    gr, gi = _fold_planes(params, device)
    m0 = torch.as_tensor(_gray_bit_masks(params)[:, None, :], device=device)   # [sf, 1, N]
    neg = torch.tensor(-1e30, dtype=F32, device=device)

    def llrs(xr: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
        sr, si = _folded_spectrum(xr, xi, gr, gi)
        mag = torch.sqrt(sr * sr + si * si)[None, :, :]             # [1, S, N]
        hi0 = torch.amax(torch.where(m0, mag, neg), dim=-1)         # [sf, S]
        hi1 = torch.amax(torch.where(m0, neg, mag), dim=-1)
        return (hi0 - hi1).T

    return llrs
