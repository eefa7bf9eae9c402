"""Single-carrier frequency-domain equalization (counterpart of
``srcdsp_tpu/chains/scfde.py``).

Single-carrier blocks with a cyclic prefix, equalized in the frequency
domain: OFDM's one-tap-per-bin maths with a single-carrier waveform (lower
PAPR).

- TX: [pilot block | S data blocks], every block CP-extended; the pilot is
  a Zadoff-Chu sequence (flat spectrum: the LS estimate is conditioned at
  every bin).
- RX (synchronized): strip CPs, LS channel estimate H = Y_pilot/X_pilot,
  then per data block the MMSE one-taps X = conj(H) Y / (|H|^2 + 1/snr)
  and an IFFT back to symbols.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.testing.signals import zadoff_chu
from srcdsp_tpu_torch.types import CF32

__all__ = ["ScfdeSpec", "make_scfde_spec", "scfde_tx", "scfde_rx"]


class ScfdeSpec(NamedTuple):
    n: int                 # block length (FFT size)
    cp: int
    pilot: torch.Tensor    # [n] complex64 known pilot block (unit amplitude)


def make_scfde_spec(n: int = 256, cp: int = 32, root: int = 25, device=None) -> ScfdeSpec:
    """The Zadoff-Chu pilot needs gcd(root, n) == 1 (any odd root for a
    power-of-two n)."""
    return ScfdeSpec(n=int(n), cp=int(cp),
                     pilot=torch.as_tensor(zadoff_chu(root, n), device=resolve(device)))


def _add_cp(blocks: torch.Tensor, cp: int) -> torch.Tensor:
    return torch.cat([blocks[..., blocks.shape[-1] - cp:], blocks], dim=-1)


def scfde_tx(spec: ScfdeSpec, symbols: torch.Tensor) -> torch.Tensor:
    """symbols [S, N] data blocks -> [(S+1)*(N+CP)] samples ([pilot | data],
    every block CP-extended)."""
    blocks = torch.cat([spec.pilot[None].to(symbols.device), symbols.to(CF32)], dim=0)
    return _add_cp(blocks, spec.cp).reshape(-1).to(CF32)


def scfde_rx(spec: ScfdeSpec, y: torch.Tensor, snr: float = 100.0
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Synchronized receive: y starts at the pilot block's CP.

    Returns (equalized symbols [S, N] complex64, H [N] channel estimate).
    snr: the linear symbol SNR of the MMSE regularizer.
    """
    l = spec.n + spec.cp
    s = y.shape[-1] // l - 1
    blocks = y[: (s + 1) * l].reshape(s + 1, l)[:, spec.cp:]
    f = torch.fft.fft(blocks, dim=-1)
    h = f[0] / torch.fft.fft(spec.pilot.to(y.device))
    w = torch.conj(h) / (torch.abs(h) ** 2 + float(np.float32(1.0 / snr)))
    eq = torch.fft.ifft(f[1:] * w[None, :], dim=-1)
    return eq.to(CF32), h.to(CF32)
