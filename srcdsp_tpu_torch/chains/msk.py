"""Coherent MSK/GMSK demodulation via the Laurent main pulse (counterpart of
``srcdsp_tpu/chains/msk.py``).

Laurent's decomposition writes an h=1/2 CPM waveform as a superposition of
PAM pulses; the main pulse c0 carries almost all the energy for GMSK
BT >= 0.3 (all of it for MSK). A coherent receiver is then a linear demod:

    matched filter c0  ->  derotate e^{-j pi n / (2 sps)}  ->  BPSK-slice
    pseudo-symbols a_k in {+-1}  ->  bits alpha_k = a_k * a_{k-1}

The pulse is identified by least squares on the host (`laurent_c0`): a long
random-bit waveform from ``testing.signals.gmsk_baseband``, derotated and
regressed on the known pseudo-symbols. The demod core is the synchronized
form (symbol timing known mod sps, no CFO); the matched filter runs through
the port's ``ops.fir.fir_full`` on the input's device.
"""

from __future__ import annotations

import numpy as np
import torch

from srcdsp_tpu_torch.ops.fir import fir_full
from srcdsp_tpu_torch.testing.signals import gmsk_baseband
from srcdsp_tpu_torch.types import CF32, F32

__all__ = ["laurent_c0", "msk_coherent_demod", "pseudo_symbols"]


def laurent_c0(sps: int, bt: float | None = 0.3, span: int = 3, c_span: int = 4,
               nsym: int = 512, seed: int = 0) -> np.ndarray:
    """LS-identified Laurent main pulse, [c_span*sps] complex128; c0[0]
    corresponds to the sample at the symbol-k boundary (host numpy)."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, nsym)
    x = gmsk_baseband(bits, sps, bt=bt, span=span).astype(np.complex128)
    n = x.size
    z = x * np.exp(-1j * np.pi * np.arange(n) / (2.0 * sps))
    a = pseudo_symbols(bits)                       # [nsym] +-1
    lc = c_span * sps
    rows = []
    rhs = []
    for k in range(c_span - 1, nsym - c_span):    # kk = k - j stays >= 0
        seg = z[k * sps:(k + 1) * sps]
        m = np.zeros((sps, lc))
        for j in range(c_span):
            kk = k - j
            m[:, j * sps:(j + 1) * sps] = a[kk] * np.eye(sps)
        rows.append(m)
        rhs.append(seg)
    c, *_ = np.linalg.lstsq(np.concatenate(rows), np.concatenate(rhs), rcond=None)
    # complex: its imaginary part carries the offset-quadrature branch, and
    # the shifted-pulse ISI is (near-)imaginary at the strobes
    return c.astype(np.complex128)


def pseudo_symbols(bits) -> np.ndarray:
    """Laurent pseudo-symbols a_k in {+-1} for bit stream b_k: exp(j(phi_k -
    pi (k+1) / 2)) with phi_k = (pi/2) sum_{i<=k} alpha_i, alpha = 2b - 1."""
    alpha = 2.0 * np.asarray(bits, np.float64) - 1.0
    phi = (np.pi / 2.0) * np.cumsum(alpha)
    k = np.arange(alpha.size)
    a = np.exp(1j * (phi - np.pi * (k + 1) / 2.0))
    return np.round(np.real(a)).astype(np.float64)


def msk_coherent_demod(x: torch.Tensor, sps: int, c0: np.ndarray
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Synchronized coherent demod: x [..., N] baseband h=1/2 CPM at `sps`
    samples/bit, symbol boundaries at k*sps, no CFO.

    Matched filter with the Laurent pulse (the per-sample derotation folded
    into its taps), strobe at the pulse's group delay, per-symbol twiddle,
    slice pseudo-symbols, differential-map to bits. Returns (bits [...,
    nsym-1] int32, soft [..., nsym-1] float32, the a_k*a_{k-1} product);
    output bit k corresponds to input bit k+1.
    """
    n = x.shape[-1]
    c0 = np.asarray(c0, np.complex128)
    lc = c0.size
    g = (np.conj(c0) * np.exp(-1j * np.pi * np.arange(lc) / (2.0 * sps))).astype(np.complex64)
    # reversed taps turn the causal convolution into the correlation sum,
    # delayed by lc-1 samples
    y = fir_full(torch.as_tensor(g[::-1].copy(), device=x.device), x.to(CF32))
    nsym = (n - (lc - 1)) // sps
    strobes = y[..., lc - 1::sps][..., :nsym]
    k = torch.arange(nsym, dtype=F32, device=x.device)
    tw = torch.exp(-1j * (np.pi / 2.0) * k).to(CF32)
    a = (strobes * tw).real
    soft = a[..., 1:] * a[..., :-1]
    return (soft > 0).to(torch.int32), soft.to(F32)
