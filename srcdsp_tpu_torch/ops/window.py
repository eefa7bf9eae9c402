"""Filter tap design: windowed-sinc lowpass, Kaiser/Hamming windows, RRC pulse.

A numpy copy of ``srcdsp_tpu/ops/window.py``: importing that module imports
the JAX package, which this package never does. Runs at chain-construction
time on the host. tests/test_torch_types_nco.py holds the taps bit-equal to
the JAX package's.
"""

from __future__ import annotations

import numpy as np


def _kaiser_beta(atten_db: float) -> float:
    """Kaiser's empirical beta for a target stopband attenuation in dB."""
    if atten_db > 50.0:
        return 0.1102 * (atten_db - 8.7)
    if atten_db >= 21.0:
        return 0.5842 * (atten_db - 21.0) ** 0.4 + 0.07886 * (atten_db - 21.0)
    return 0.0


def kaiser(n: int, beta: float) -> np.ndarray:
    """Kaiser window of length n (symmetric)."""
    k = np.arange(n, dtype=np.float64)
    alpha = (n - 1) / 2.0
    arg = beta * np.sqrt(np.maximum(0.0, 1.0 - ((k - alpha) / alpha) ** 2)) if n > 1 else np.zeros(1)
    return np.i0(arg) / np.i0(beta) if beta > 0 else np.ones(n)


def hamming(n: int) -> np.ndarray:
    k = np.arange(n, dtype=np.float64)
    return 0.54 - 0.46 * np.cos(2.0 * np.pi * k / (n - 1)) if n > 1 else np.ones(1)


def lowpass(num_taps: int, cutoff: float, window: str = "hamming",
            atten_db: float = 60.0, fs: float = 1.0) -> np.ndarray:
    """Windowed-sinc lowpass FIR taps, unit DC gain.

    cutoff is the -6 dB edge in the same units as fs (cycles/sample when
    fs == 1). Equivalent to scipy.signal.firwin(num_taps, cutoff, fs=fs,
    window=...) up to float rounding.
    """
    if not 0 < cutoff < fs / 2:
        raise ValueError(f"cutoff must be in (0, fs/2), got {cutoff} @ fs={fs}")
    fc = cutoff / fs  # normalized cycles/sample
    k = np.arange(num_taps, dtype=np.float64) - (num_taps - 1) / 2.0
    h = 2.0 * fc * np.sinc(2.0 * fc * k)
    if window == "hamming":
        w = hamming(num_taps)
    elif window == "kaiser":
        w = kaiser(num_taps, _kaiser_beta(atten_db))
    elif window == "rect":
        w = np.ones(num_taps)
    else:
        raise ValueError(f"unknown window {window!r}")
    h = h * w
    h /= h.sum()  # unit DC gain
    return h.astype(np.float32)


def root_raised_cosine(sps: int, num_symbols: int, beta: float = 0.35) -> np.ndarray:
    """Root-raised-cosine pulse (PSK matched filter), unit energy.

    sps samples/symbol, span of num_symbols symbols, roll-off beta.
    """
    n = sps * num_symbols + 1
    t = (np.arange(n, dtype=np.float64) - (n - 1) / 2.0) / sps
    h = np.empty(n)
    for i, ti in enumerate(t):
        if abs(ti) < 1e-12:
            h[i] = 1.0 - beta + 4.0 * beta / np.pi
        elif beta > 0 and abs(abs(4.0 * beta * ti) - 1.0) < 1e-9:
            h[i] = (beta / np.sqrt(2.0)) * (
                (1 + 2 / np.pi) * np.sin(np.pi / (4 * beta))
                + (1 - 2 / np.pi) * np.cos(np.pi / (4 * beta)))
        else:
            num = np.sin(np.pi * ti * (1 - beta)) + 4 * beta * ti * np.cos(np.pi * ti * (1 + beta))
            den = np.pi * ti * (1 - (4 * beta * ti) ** 2)
            h[i] = num / den
    h /= np.sqrt(np.sum(h * h))
    return h.astype(np.float32)


def gaussian_freq_pulse(sps: int, bt: float = 0.3, span: int = 3, h: float = 0.5) -> np.ndarray:
    """Gaussian CPM frequency pulse (cycles/sample), integrating to h/2
    cycles per bit: the Gaussian lowpass with -3 dB at `bt` (bit-period
    units) convolved with the one-bit rectangle. Shared by the GMSK
    modulator fixture (testing.signals.gmsk_baseband) and the CPM
    transmitter (chains.tx.make_gmsk_tx)."""
    tt = (np.arange(span * sps) - (span * sps - 1) / 2.0) / sps
    sigma = np.sqrt(np.log(2.0)) / (2.0 * np.pi * bt)
    g = np.exp(-0.5 * (tt / sigma) ** 2)
    p = np.convolve(np.ones(sps), g)
    return (p / p.sum() * (h / 2.0)).astype(np.float64)
