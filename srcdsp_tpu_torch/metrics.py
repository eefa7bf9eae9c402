"""Link-quality metrics: EVM / MER, aligned BER/SER counting, Goertzel,
cross-correlation and delay estimation (counterpart of
``srcdsp_tpu/metrics.py``, copied: the port imports nothing of the JAX
package).

Host-facing analysis: numpy in, numpy out. Callers bring results to the
host themselves (``tensor.cpu().numpy()``); nothing here touches a device.
"""

from __future__ import annotations

import numpy as np


def evm_rms(rx, ref, normalize: str = "rms") -> float:
    """RMS error-vector magnitude of rx vs the reference symbols, as a
    FRACTION (multiply by 100 for percent). normalize: 'rms' (reference
    RMS power, the 3GPP convention) or 'peak' (largest |ref|)."""
    rx = np.asarray(rx).ravel()
    ref = np.asarray(ref).ravel()
    if rx.size != ref.size:
        raise ValueError(f"size mismatch {rx.size} vs {ref.size}")
    err = np.mean(np.abs(rx - ref) ** 2)
    if normalize == "rms":
        den = np.mean(np.abs(ref) ** 2)
    elif normalize == "peak":
        den = np.max(np.abs(ref)) ** 2
    else:
        raise ValueError(f"unknown normalize {normalize!r}")
    return float(np.sqrt(err / den))


def evm_db(rx, ref, **kw) -> float:
    """EVM in dB (20*log10 of the fraction; more negative = better)."""
    return float(20.0 * np.log10(max(evm_rms(rx, ref, **kw), 1e-30)))


def mer_db(rx, ref) -> float:
    """Modulation error ratio in dB: signal power over error power
    (== -evm_db under 'rms' normalization)."""
    return -evm_db(rx, ref, normalize="rms")


def evm_blind(rx, constellation, **kw) -> float:
    """EVM against nearest-constellation-point decisions (no reference
    sequence needed). constellation: [M] complex points."""
    rx = np.asarray(rx).ravel()
    pts = np.asarray(constellation).ravel()
    idx = np.argmin(np.abs(rx[:, None] - pts[None, :]), axis=1)
    return evm_rms(rx, pts[idx], **kw)


def align_sequences(tx, rx, max_lag: int = 32):
    """Best integer alignment of a decoded sequence against the sent one.

    Searches lags in [-max_lag, max_lag] (positive lag = rx is DELAYED:
    tx[0] lines up with rx[lag]; negative = rx is missing the first |lag|
    entries) and returns (lag, tx_aligned, rx_aligned) with the
    overlapping segments trimmed to equal length, picking the lag with
    the fewest mismatches. Works for bits, symbol indices, bytes.
    """
    tx = np.asarray(tx).ravel()
    rx = np.asarray(rx).ravel()
    best = (None, 1.0 + max(tx.size, rx.size))
    for lag in range(-max_lag, max_lag + 1):
        ts, rs = max(-lag, 0), max(lag, 0)
        m = min(tx.size - ts, rx.size - rs)
        if m <= 0:
            continue
        errs = int(np.sum(tx[ts:ts + m] != rx[rs:rs + m]))
        # prefer more overlap on ties (errs weighted per element)
        score = errs + (1.0 - m / max(tx.size, rx.size)) * 0.5
        if score < best[1]:
            best = (lag, score)
    lag = best[0]
    if lag is None:
        raise ValueError("no overlap within max_lag")
    ts, rs = max(-lag, 0), max(lag, 0)
    m = min(tx.size - ts, rx.size - rs)
    return lag, tx[ts:ts + m], rx[rs:rs + m]


def ber(tx_bits, rx_bits, max_lag: int = 32):
    """(bit error rate, lag, compared count) after the best alignment."""
    lag, a, b = align_sequences(tx_bits, rx_bits, max_lag)
    return float(np.mean(a != b)), lag, a.size


def ser(tx_syms, rx_syms, max_lag: int = 32):
    """(symbol error rate, lag, compared count) after alignment."""
    return ber(tx_syms, rx_syms, max_lag)


def goertzel(x, freq: float, fs: float = 1.0):
    """Single-bin DFT at an arbitrary (non-grid) frequency: the complex
    correlation sum(x[n] e^{-j2pi f n}) / N. Accepts [..., N] batches;
    one dot product — the TPU-friendly form of the Goertzel filter
    (recursion replaced by the projection it computes)."""
    x = np.asarray(x)
    n = x.shape[-1]
    ph = np.exp(-2j * np.pi * (freq / fs) * np.arange(n))
    return x @ ph / n


def tone_power_db(x, freq: float, fs: float = 1.0) -> float:
    """Power of the tone at `freq` relative to total power, in dB."""
    x = np.asarray(x).ravel()
    p_tone = np.abs(goertzel(x, freq, fs)) ** 2
    p_tot = np.mean(np.abs(x) ** 2)
    return float(10.0 * np.log10(max(p_tone, 1e-30) / max(p_tot, 1e-30)))


def xcorr(a, b, max_lag: int | None = None):
    """Cross-correlation r[l] = sum_n a[n+l] * conj(b[n]) via FFT.

    Returns (lags, r): positive lag means `a` contains `b` DELAYED by l
    samples. max_lag trims the output window (default: full +-(N-1))."""
    a = np.asarray(a)
    b = np.asarray(b)
    n = max(a.shape[-1], b.shape[-1])
    nfft = 1 << int(np.ceil(np.log2(2 * n - 1)))
    r = np.fft.ifft(np.fft.fft(a, nfft) * np.conj(np.fft.fft(b, nfft)))
    lags = np.concatenate([np.arange(0, n), np.arange(-(n - 1), 0)])
    r = np.concatenate([r[-(n - 1):], r[:n]])
    lags = np.concatenate([lags[-(n - 1):], lags[:n]])
    if max_lag is not None:
        keep = np.abs(lags) <= max_lag
        lags, r = lags[keep], r[keep]
    return lags, r


def delay_estimate(a, b, max_lag: int | None = None) -> float:
    """Sub-sample delay of `b`'s waveform inside `a` (TDOA).

    Coarse integer lag from the |xcorr| peak, then the fraction from the
    cross-spectrum phase slope: for a pure delay tau,
    angle(A(f) conj(B(f))) = -2*pi*f*tau — a |S|^2-weighted LS slope fit
    is unbiased where parabolic |r| interpolation is not (broad
    correlation peaks of band-limited signals pull it toward integers)."""
    a = np.asarray(a)
    b = np.asarray(b)
    lags, r = xcorr(a, b, max_lag=max_lag)
    k0 = int(lags[int(np.argmax(np.abs(r)))])
    n = max(a.shape[-1], b.shape[-1])
    nfft = 1 << int(np.ceil(np.log2(2 * n)))
    s = np.fft.fft(a, nfft) * np.conj(np.fft.fft(b, nfft))
    f = np.fft.fftfreq(nfft)
    # remove the integer part so the residual phase never wraps
    phi = np.angle(s * np.exp(2j * np.pi * f * k0))
    w = np.abs(s) ** 2
    denom = np.sum(w * f * f)
    frac = 0.0 if denom == 0 else float(-np.sum(w * f * phi)
                                        / (2.0 * np.pi * denom))
    return k0 + float(np.clip(frac, -1.0, 1.0))


__all__ = [
    "evm_rms", "evm_db", "mer_db", "evm_blind", "align_sequences",
    "ber", "ser", "goertzel", "tone_power_db", "xcorr", "delay_estimate",
]
