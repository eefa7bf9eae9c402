"""Blind wideband signal survey (counterpart of
``srcdsp_tpu/chains/blindscan.py``): find and characterize unknown signals
in a capture with no prior knowledge.

- **Detection** (`scan`): Welch PSD thresholded against a global noise floor
  (a low quantile of the averaged PSD), adjacent occupied bins grouped into
  segments, per-segment center (power centroid), bandwidth and SNR.
- **Baud rate** (`baud_estimate`): the |x|^2 cyclostationary line on a
  zero-padded FFT, refined by parabolic interpolation.
- **Modulation classification** (`classify_mpsk`): x^M spectral-line tests,
  certified out of sample by segment phase coherence.
- **CSS detection** (`detect_css`): the dechirped top-2-bin energy fraction
  per spreading factor.

Where each part runs: the device stages are torch on the capture's device
(a numpy capture goes to `device`, None = the card): `scan`'s Welch PSD
(``ops.spectrum.welch``) and `detect_css`'s dechirp FFTs with their top-2
and energy sums. The band logic (the quantile floor, the threshold, the
morphological closing, the run edges, the centroids) runs in host numpy on
the copied-back PSD, as in the reference; `baud_estimate` and
`classify_mpsk` are host numpy throughout, as the reference's are. None of
this is card work a later optimisation has yet moved.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from srcdsp_tpu_torch.chains.css import base_upchirp
from srcdsp_tpu_torch.device import as_tensor_on
from srcdsp_tpu_torch.ops.spectrum import welch
from srcdsp_tpu_torch.types import CF32

__all__ = ["Detection", "scan", "baud_estimate", "classify_mpsk", "detect_css"]


class Detection(NamedTuple):
    center: float      # cycles/sample, in (-0.5, 0.5]
    bandwidth: float   # cycles/sample (detected extent)
    power_db: float    # mean in-band PSD over the noise floor


def scan(x, nfft: int = 4096, thresh_db: float = 10.0, min_bins: int = 2,
         floor_quantile: float = 0.2, merge_gap: int = 8, device=None) -> list[Detection]:
    """Detect occupied bands in a capture.

    The noise floor is the `floor_quantile` quantile of the Welch PSD; bins
    above floor + `thresh_db` are occupied; gaps up to `merge_gap` bins are
    closed; contiguous runs (>= min_bins) become Detections, strongest
    first. The PSD is computed on the capture's device and copied back once.
    """
    psd = welch(as_tensor_on(x, device, CF32), nfft=nfft).cpu().numpy().astype(np.float64)
    floor = float(np.quantile(psd, floor_quantile))
    det = psd > floor * 10.0 ** (thresh_db / 10.0)
    freqs = np.fft.fftfreq(nfft)
    order = np.argsort(freqs)
    f_s, p_s, d_s = freqs[order], psd[order], det[order]
    if merge_gap > 0:          # morphological closing along frequency
        kern = np.ones(merge_gap + 1)
        dil = np.convolve(d_s.astype(np.float64), kern, mode="same") > 0
        d_s = np.convolve((~dil).astype(np.float64), kern, mode="same") == 0
    edges = np.flatnonzero(np.diff(np.concatenate([[0], d_s.astype(np.int8), [0]])))
    out = []
    for lo, hi in zip(edges[0::2], edges[1::2]):
        if hi - lo < min_bins:
            continue
        p = p_s[lo:hi]
        f = f_s[lo:hi]
        c = float(np.sum(f * p) / np.sum(p))
        snr = 10.0 * np.log10(max(float(np.mean(p)) / max(floor, 1e-30), 1e-30))
        out.append(Detection(center=c, bandwidth=float((hi - lo) / nfft), power_db=snr))
    out.sort(key=lambda d: -d.power_db)
    return out


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _peak_line(z: np.ndarray, f_lo: float, f_hi: float, pad: int = 4) -> tuple[float, float]:
    """(frequency, line-to-background dB) of the strongest spectral line of z
    in [f_lo, f_hi], via a pad-x zero-padded FFT + parabolic refinement."""
    z = np.asarray(z)
    n = z.shape[-1]
    nfft = pad * (1 << int(np.ceil(np.log2(max(n, 2)))))
    s = np.abs(np.fft.fft(z, nfft)) ** 2
    f = np.fft.fftfreq(nfft)
    mask = (f >= f_lo) & (f <= f_hi)
    if not mask.any():
        return 0.0, -np.inf
    idx = np.flatnonzero(mask)
    k = idx[int(np.argmax(s[idx]))]
    if 0 < k < nfft - 1:
        y0, y1, y2 = (np.log(s[k - 1] + 1e-300), np.log(s[k] + 1e-300),
                      np.log(s[k + 1] + 1e-300))
        den = y0 - 2 * y1 + y2
        frac = 0.0 if den == 0 else float(np.clip(0.5 * (y0 - y2) / den, -0.5, 0.5))
    else:
        frac = 0.0
    line_db = 10.0 * np.log10(max(s[k], 1e-300) / max(float(np.median(s[idx])), 1e-300))
    return float(f[k] + frac / nfft), line_db


def _coherence(z: np.ndarray, freq: float, start: int = 0, k: int = 8) -> float:
    """Phase coherence of the `freq` projection across k segments of z:
    ~1 for a true spectral line, ~1/sqrt(k) for a continuum peak."""
    z = np.asarray(z)
    n = (z.shape[-1] // k) * k
    ph = np.exp(-2j * np.pi * freq * np.arange(start, start + n))
    proj = (z[:n] * ph).reshape(k, -1).mean(axis=-1)
    denom = float(np.sum(np.abs(proj)))
    return 0.0 if denom == 0 else float(np.abs(np.sum(proj)) / denom)


def baud_estimate(x, f_lo: float = 1e-3, f_hi: float = 0.5) -> tuple[float, float]:
    """Symbol-rate estimate from the |x|^2 cyclostationary line (host numpy).
    Returns (baud in cycles/sample, line-to-background dB)."""
    env = np.abs(_host(x)) ** 2
    env = env - env.mean()
    return _peak_line(env.astype(np.complex128), f_lo, f_hi)


def classify_mpsk(x, orders=(1, 2, 4, 8), min_coherence: float = 0.7,
                  min_fraction: float = 0.01):
    """Smallest M in `orders` whose x^M spectrum carries a true line (host
    numpy). Returns (order or 0, {M: (line_fraction, coherence)}): the
    candidate frequency from the first half of the record, the segment phase
    coherence measured on the second half, plus a peak-power-fraction floor."""
    x = _host(x)
    x = x / max(float(np.sqrt(np.mean(np.abs(x) ** 2))), 1e-30)
    h = x.shape[-1] // 2
    report = {}
    for m in orders:
        z = (x ** m).astype(np.complex128)
        freq, _ = _peak_line(z[:h], -0.5, 0.5)
        nfft = 4 * (1 << int(np.ceil(np.log2(max(z.shape[-1], 2)))))
        s = np.abs(np.fft.fft(z, nfft)) ** 2
        frac = float(s.max() / max(s.sum(), 1e-300))
        coh = _coherence(z[h:], freq, start=h)
        report[m] = (float(f"{frac:.2e}"), round(coh, 3))
        if frac > min_fraction and coh > min_coherence:
            return m, report
    return 0, report


def detect_css(x, sf_range=range(6, 13), min_score: float = 2.0, device=None):
    """Blind CSS (LoRa-class) detection + spreading-factor estimate.

    Dechirping with the conjugate base chirp of the right length concentrates
    every N-chip window into one or two DFT tones; the statistic per SF is
    the mean top-2-bin energy fraction across frames over its noise-only
    expectation (ln N + 1)/N, maximized over up- and down-chirp hypotheses.
    The dechirp FFTs and the per-frame sums run on the capture's device.

    Returns {'detected', 'sf', 'score', 'direction', 'scores'}.
    """
    xx = as_tensor_on(x, device, CF32)
    dev = xx.device
    scores = {}
    best = (0.0, None, None)
    for sf in sf_range:
        n = 1 << sf
        s = xx.shape[-1] // n
        if s < 4:
            continue
        fr = xx[: s * n].reshape(s, n)
        u = base_upchirp(n)
        noise_exp = (np.log(n) + 1.0) / n
        for direction, dc in (("up", np.conj(u)), ("down", u)):
            spec = torch.abs(torch.fft.fft(fr * torch.as_tensor(dc, device=dev), dim=-1)) ** 2
            top2 = torch.topk(spec, 2, dim=-1).values.sum(dim=-1)
            frac = float(torch.mean(top2 / torch.clamp(spec.sum(dim=-1), min=1e-30)))
            sc = frac / (2.0 * noise_exp)
            scores[(sf, direction)] = round(sc, 2)
            if sc > best[0]:
                best = (sc, sf, direction)
    detected = best[0] >= min_score
    return {"detected": bool(detected),
            "sf": best[1] if detected else None,
            "direction": best[2] if detected else None,
            "score": round(best[0], 2), "scores": scores}
