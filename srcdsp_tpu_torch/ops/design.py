"""FIR design beyond windowed-sinc: least-squares and equiripple (counterpart
of ``srcdsp_tpu/ops/design.py``).

A numpy copy: importing the JAX module imports the JAX package, which this
package never does. Everything here runs on the host at chain-construction
time and returns numpy taps; tests/test_torch_design.py holds every design
bit-equal to the JAX package's.

- `firls`: exact weighted least-squares linear-phase design (type I) via
  the analytic band integrals (no grid), matching scipy.signal.firls.
- `equiripple`: minimax (Parks-McClellan-equivalent) design by Lawson's
  iteratively-reweighted least squares on a dense grid; returns the achieved
  ripple alongside the taps.
- `highpass` / `bandpass` / `bandstop`: spectral transforms of the
  windowed-sinc lowpass (`ops.window.lowpass`).
- `freq_response` / `group_delay` / `kaiser_num_taps` / `kaiser_lowpass`:
  analysis and sizing helpers.
"""

from __future__ import annotations

import numpy as np

from srcdsp_tpu_torch.ops.window import lowpass


def _cos_integral(k: int, f0: float, f1: float) -> float:
    """Integral of cos(2*pi*k*f) df over [f0, f1]."""
    if k == 0:
        return f1 - f0
    w = 2.0 * np.pi * k
    return (np.sin(w * f1) - np.sin(w * f0)) / w


def _fcos_integral(k: int, f0: float, f1: float) -> float:
    """Integral of f * cos(2*pi*k*f) df over [f0, f1]."""
    if k == 0:
        return 0.5 * (f1 * f1 - f0 * f0)
    w = 2.0 * np.pi * k
    return ((np.cos(w * f1) - np.cos(w * f0)) / (w * w)
            + (f1 * np.sin(w * f1) - f0 * np.sin(w * f0)) / w)


def firls(num_taps: int, bands, desired, weights=None,
          fs: float = 1.0) -> np.ndarray:
    """Weighted least-squares linear-phase FIR (type I: odd num_taps).

    bands: flat sequence of band edges [b0_lo, b0_hi, b1_lo, b1_hi, ...]
    in the units of fs (monotone, within [0, fs/2]); desired: amplitude at
    each edge (linear interpolation inside a band, scipy.signal.firls
    convention); weights: one per band (default 1). Gaps between bands are
    don't-care. Returns symmetric taps h[num_taps] (float64 — cast at use).
    """
    if num_taps % 2 != 1:
        raise ValueError(f"firls: num_taps must be odd (type I), got {num_taps}")
    bands = np.asarray(bands, np.float64) / fs
    desired = np.asarray(desired, np.float64)
    if bands.ndim != 1 or bands.size % 2 or bands.size != desired.size:
        raise ValueError("bands must be flat edge pairs matching desired")
    nb = bands.size // 2
    if weights is None:
        weights = np.ones(nb)
    weights = np.asarray(weights, np.float64)
    if np.any(np.diff(bands) < 0) or bands[0] < 0 or bands[-1] > 0.5 + 1e-12:
        raise ValueError("band edges must be monotone in [0, fs/2]")

    m = (num_taps - 1) // 2
    # A(f) = a0 + sum_k a_k cos(2 pi k f); minimize sum_b w_b *
    # int_b (A - D)^2. Normal equations Q a = r with
    # Q[j,k] = sum_b w_b int_b cos(2pi j f) cos(2pi k f)
    #        = 0.5 * sum_b w_b [I(|j-k|) + I(j+k)],
    # r[k]   = sum_b w_b int_b D(f) cos(2pi k f),  D linear in f per band.
    q1 = np.zeros(2 * m + 1)     # q1[d] = sum_b w_b * I_cos(d) over bands
    for d in range(2 * m + 1):
        q1[d] = sum(w * _cos_integral(d, lo, hi)
                    for w, lo, hi in zip(weights, bands[0::2], bands[1::2]))
    jj, kk = np.meshgrid(np.arange(m + 1), np.arange(m + 1), indexing="ij")
    q = 0.5 * (q1[np.abs(jj - kk)] + q1[jj + kk])
    r = np.zeros(m + 1)
    for b in range(nb):
        lo, hi = bands[2 * b], bands[2 * b + 1]
        d0, d1 = desired[2 * b], desired[2 * b + 1]
        if hi - lo < 1e-15:
            continue
        slope = (d1 - d0) / (hi - lo)
        icpt = d0 - slope * lo          # D(f) = icpt + slope * f
        for k in range(m + 1):
            r[k] += weights[b] * (icpt * _cos_integral(k, lo, hi)
                                  + slope * _fcos_integral(k, lo, hi))
    a = np.linalg.solve(q, r)
    h = np.concatenate([a[m:0:-1] / 2.0, a[0:1], a[1:] / 2.0])
    return h


def equiripple(num_taps: int, bands, desired, weights=None, fs: float = 1.0,
               grid_density: int = 16, iters: int = 60,
               return_ripple: bool = False):
    """Minimax linear-phase FIR (type I) via Lawson's IRLS.

    Same band conventions as `firls`. Converges to the Chebyshev
    (Parks-McClellan) solution: Lawson's algorithm re-weights the
    least-squares fit by the error magnitude each iteration, which drives
    the weighted error to the equiripple profile. grid_density points per
    tap per unit band. Returns taps, or (taps, ripple) — ripple is the
    max weighted error over the design grid.
    """
    if num_taps % 2 != 1:
        raise ValueError(f"equiripple: num_taps must be odd, got {num_taps}")
    bands = np.asarray(bands, np.float64) / fs
    desired = np.asarray(desired, np.float64)
    nb = bands.size // 2
    if weights is None:
        weights = np.ones(nb)
    weights = np.asarray(weights, np.float64)

    m = (num_taps - 1) // 2
    # dense grid over the union of bands, with per-point desired/weight
    fgrid, dgrid, wgrid = [], [], []
    for b in range(nb):
        lo, hi = bands[2 * b], bands[2 * b + 1]
        npts = max(8, int(grid_density * (m + 1) * (hi - lo) * 2) + 1)
        f = np.linspace(lo, hi, npts)
        fgrid.append(f)
        d0, d1 = desired[2 * b], desired[2 * b + 1]
        dgrid.append(d0 + (d1 - d0) * ((f - lo) / max(hi - lo, 1e-30)))
        wgrid.append(np.full(npts, weights[b]))
    f = np.concatenate(fgrid)
    d = np.concatenate(dgrid)
    w = np.concatenate(wgrid)

    k = np.arange(m + 1)
    c = np.cos(2.0 * np.pi * f[:, None] * k[None, :])   # A = C @ a
    lw = w.copy()                                       # Lawson weights
    a = None
    for _ in range(iters):
        sw = np.sqrt(lw)
        a, *_ = np.linalg.lstsq(c * sw[:, None], d * sw, rcond=None)
        err = np.abs(c @ a - d) * w
        # Lawson update: w <- w * |e|, renormalized; floor keeps points alive
        lw = lw * np.maximum(err, 1e-12 * err.max())
        lw /= lw.sum()
    ripple = float(np.max(np.abs(c @ a - d) * w))
    h = np.concatenate([a[m:0:-1] / 2.0, a[0:1], a[1:] / 2.0])
    return (h, ripple) if return_ripple else h


def highpass(num_taps: int, cutoff: float, fs: float = 1.0,
             **kw) -> np.ndarray:
    """Windowed-sinc highpass via spectral inversion of `lowpass`.

    num_taps must be odd (type I — type II highpass is degenerate at
    Nyquist)."""
    if num_taps % 2 != 1:
        raise ValueError("highpass needs odd num_taps")
    h = -lowpass(num_taps, cutoff, fs=fs, **kw).astype(np.float64)
    h[(num_taps - 1) // 2] += 1.0
    return h.astype(np.float32)


def bandpass(num_taps: int, f_lo: float, f_hi: float, fs: float = 1.0,
             **kw) -> np.ndarray:
    """Windowed-sinc bandpass: lowpass modulated to the band center.

    Peak gain normalized to 1 at the center frequency."""
    if not 0 < f_lo < f_hi < fs / 2:
        raise ValueError(f"need 0 < f_lo < f_hi < fs/2, got {f_lo}, {f_hi}")
    bw2 = (f_hi - f_lo) / 2.0
    fc = (f_hi + f_lo) / 2.0
    h = lowpass(num_taps, bw2, fs=fs, **kw).astype(np.float64)
    k = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = 2.0 * h * np.cos(2.0 * np.pi * (fc / fs) * k)
    # normalize gain at fc to exactly 1
    z = np.exp(-2j * np.pi * (fc / fs) * np.arange(num_taps))
    h /= np.abs(np.sum(h * z))
    return h.astype(np.float32)


def bandstop(num_taps: int, f_lo: float, f_hi: float, fs: float = 1.0,
             **kw) -> np.ndarray:
    """Windowed-sinc bandstop via spectral inversion of `bandpass`."""
    if num_taps % 2 != 1:
        raise ValueError("bandstop needs odd num_taps")
    h = -bandpass(num_taps, f_lo, f_hi, fs=fs, **kw).astype(np.float64)
    h[(num_taps - 1) // 2] += 1.0
    return h.astype(np.float32)


def freq_response(h, nfreq: int = 1024, fs: float = 1.0):
    """(freqs, complex response) of FIR taps on [0, fs/2]."""
    h = np.asarray(h, np.float64)
    f = np.linspace(0.0, 0.5, nfreq)
    z = np.exp(-2j * np.pi * np.outer(f, np.arange(h.size)))
    return f * fs, z @ h


def group_delay(h, nfreq: int = 1024, fs: float = 1.0):
    """(freqs, group delay in samples). Exact for any FIR:
    tau(w) = Re{ (sum n h[n] e^-jwn) / (sum h[n] e^-jwn) }."""
    h = np.asarray(h, np.float64)
    f = np.linspace(0.0, 0.5, nfreq)
    n = np.arange(h.size)
    z = np.exp(-2j * np.pi * np.outer(f, n))
    num = z @ (n * h)
    den = z @ h
    small = np.abs(den) < 1e-12
    tau = np.real(num / np.where(small, 1.0, den))
    tau[small] = np.nan
    return f * fs, tau


def kaiser_num_taps(atten_db: float, transition: float,
                    fs: float = 1.0) -> int:
    """Kaiser's estimate of the tap count for a windowed-sinc design with
    the given stopband attenuation (dB) and transition width (units of
    fs). Rounded up to the next odd count."""
    dw = 2.0 * np.pi * transition / fs
    n = int(np.ceil((atten_db - 7.95) / (2.285 * dw))) + 1
    return n + 1 if n % 2 == 0 else n


def kaiser_lowpass(cutoff: float, transition: float, atten_db: float = 60.0,
                   fs: float = 1.0) -> np.ndarray:
    """One-call Kaiser design: sized by `kaiser_num_taps`, windowed-sinc
    with the matched beta (`ops.window._kaiser_beta`)."""
    n = kaiser_num_taps(atten_db, transition, fs)
    return lowpass(n, cutoff, window="kaiser", atten_db=atten_db, fs=fs)


__all__ = [
    "firls", "equiripple", "highpass", "bandpass", "bandstop",
    "freq_response", "group_delay", "kaiser_num_taps", "kaiser_lowpass",
]
