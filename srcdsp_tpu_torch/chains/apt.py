"""NOAA APT weather-satellite imagery (counterpart of ``srcdsp_tpu/chains/apt.py``).

The baseband is a 2400 Hz subcarrier amplitude-modulated by the video at
4160 words/s (two lines a second, 2080 words a line). The receiver:

    MPX   -> mix at 2400 Hz + lowpass -> envelope 2|z|       (capture's device)
    env   -> integrate-and-dump over sps samples -> words    (capture's device)
    words -> sync-A correlation folded over the line -> lines (host)

Line layout (words): sync A 39 | space A 47 | video A 909 | telemetry A 45 |
sync B 39 | space B 47 | video B 909 | telemetry B 45. The lowpass is the
reference's `jnp.convolve(..., mode="same")` (`ops.fir.convolve_same`); the
mixing phase is the reference's exact float64 host ramp cast to float32
(`ops.nco.host_phase`).
`make_apt_params` puts the lowpass taps on a device; a numpy MPX goes there.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from srcdsp_tpu_torch.device import as_tensor_on, resolve, to_host
from srcdsp_tpu_torch.ops.fir import convolve_same
from srcdsp_tpu_torch.ops.nco import host_phase
from srcdsp_tpu_torch.ops.window import lowpass
from srcdsp_tpu_torch.types import F32

__all__ = ["AptParams", "make_apt_params", "apt_line_layout", "apt_sync_a", "apt_sync_b",
           "apt_build_lines", "apt_modulate", "apt_envelope", "apt_words", "apt_find_sync",
           "apt_decode_lines", "apt_decode_mpx"]

WORDS_PER_LINE = 2080
WORD_RATE = 4160.0
SUBCARRIER_HZ = 2400.0

_LAYOUT = (("sync_a", 39), ("space_a", 47), ("video_a", 909), ("telemetry_a", 45),
           ("sync_b", 39), ("space_b", 47), ("video_b", 909), ("telemetry_b", 45))


def apt_line_layout() -> dict:
    """{name: (start, width)} word offsets of each line segment."""
    out, off = {}, 0
    for name, w in _LAYOUT:
        out[name] = (off, w)
        off += w
    assert off == WORDS_PER_LINE
    return out


def apt_sync_a() -> np.ndarray:
    """[39] sync A: 4 low, 7 cycles of (2 high, 2 low), 7 low (1040 Hz)."""
    out = np.zeros(39, np.float32)
    for c in range(7):
        out[4 + 4 * c: 4 + 4 * c + 2] = 1.0
    return out


def apt_sync_b() -> np.ndarray:
    """[39] sync B: 4 low, 7 pulses of (3 high, 2 low) (832 pps)."""
    out = np.zeros(39, np.float32)
    for c in range(7):
        out[4 + 5 * c: 4 + 5 * c + 3] = 1.0
    return out


class AptParams(NamedTuple):
    fs: float               # MPX sample rate
    sps: float              # samples per word = fs / 4160 (integer)
    lo: float               # subcarrier amplitude at luminance 0
    hi: float               # subcarrier amplitude at luminance 1
    lp_taps: torch.Tensor   # [taps] float32 envelope lowpass on a device


def make_apt_params(fs: float = 20800.0, lo: float = 0.1, hi: float = 0.95, taps: int = 127,
                    device=None) -> AptParams:
    """fs a multiple of 4160 (default 5 samples a word); the lowpass (cutoff
    0.6 x the word rate) passes the video and rejects the 4800 Hz image.
    Taps on `device` (the card unless it says otherwise)."""
    sps = fs / WORD_RATE
    if abs(sps - round(sps)) > 1e-9:
        raise ValueError(f"fs {fs} not a multiple of the 4160 word rate")
    return AptParams(fs=float(fs), sps=float(round(sps)), lo=lo, hi=hi,
                     lp_taps=torch.as_tensor(lowpass(taps, 0.6 * (WORD_RATE / fs)),
                                             device=resolve(device)))


def apt_build_lines(image, image_b=None) -> np.ndarray:
    """Image rows [L, 909] in [0, 1] -> word lines [L, 2080] (host fixture);
    channel B carries image_b (default the inverse of A); telemetry wedges
    step through 8 levels every 8 lines."""
    img = to_host(image).astype(np.float32)
    if img.ndim != 2 or img.shape[1] != 909:
        raise ValueError(f"image must be [L, 909], got {img.shape}")
    imgb = 1.0 - img if image_b is None else to_host(image_b).astype(np.float32)
    lay = apt_line_layout()
    lines = np.zeros((img.shape[0], WORDS_PER_LINE), np.float32)
    for row in range(img.shape[0]):
        wedge = ((row // 8) % 8 + 1) / 8.0
        seg = {"sync_a": apt_sync_a(), "space_a": np.zeros(47, np.float32), "video_a": img[row],
               "telemetry_a": np.full(45, wedge, np.float32), "sync_b": apt_sync_b(),
               "space_b": np.ones(47, np.float32), "video_b": imgb[row],
               "telemetry_b": np.full(45, wedge, np.float32)}
        for name, (off, w) in lay.items():
            lines[row, off: off + w] = seg[name]
    return lines


def apt_modulate(params: AptParams, lines) -> np.ndarray:
    """Word lines [L, 2080] -> MPX f32 [L * 2080 * sps] (host fixture): each
    word held for sps samples, amplitude lo + (hi - lo) word on the 2400 Hz
    cosine."""
    words = to_host(lines).astype(np.float32).reshape(-1)
    amp = params.lo + (params.hi - params.lo) * np.repeat(words, int(params.sps))
    t = np.arange(amp.size) / params.fs
    return (amp * np.cos(2 * np.pi * SUBCARRIER_HZ * t)).astype(np.float32)


def apt_envelope(params: AptParams, mpx) -> torch.Tensor:
    """MPX f32 [N] -> video envelope [N] on the MPX's device (a numpy MPX
    goes to the taps' device): mix at 2400 Hz, the "same" lowpass of each
    plane, 2|z|."""
    x = as_tensor_on(mpx, params.lp_taps.device, F32)
    ph = torch.as_tensor(host_phase(SUBCARRIER_HZ / params.fs, x.shape[-1]), device=x.device)
    h = params.lp_taps.to(x.device)
    zr = convolve_same(x * torch.cos(ph), h)
    zi = convolve_same(x * -torch.sin(ph), h)
    return 2.0 * torch.sqrt(zr * zr + zi * zi)


def apt_words(params: AptParams, env: torch.Tensor) -> torch.Tensor:
    """Envelope [N] -> words [N // sps] by integrate-and-dump, mapped back to
    luminance through (lo, hi)."""
    sps = int(params.sps)
    nw = env.shape[-1] // sps
    w = torch.mean(env[: nw * sps].reshape(nw, sps), dim=-1)
    return (w - params.lo) / (params.hi - params.lo)


def apt_find_sync(words) -> tuple[int, float]:
    """Word stream (any device) -> (offset of the first full line, score):
    the zero-mean sync-A template correlated at every offset, folded modulo
    the line length so that every line votes (host sink)."""
    w = to_host(words).astype(np.float32).reshape(-1)
    tpl = apt_sync_a()
    corr = np.correlate(w, tpl - tpl.mean(), mode="valid")
    if corr.size < WORDS_PER_LINE:
        return 0, 0.0
    nl = corr.size // WORDS_PER_LINE
    score = corr[: nl * WORDS_PER_LINE].reshape(nl, WORDS_PER_LINE).sum(axis=0)
    off = int(np.argmax(score))
    return off, float(score[off] / max(nl, 1))


def apt_decode_lines(params: AptParams, words) -> dict:
    """Word stream (any device) -> {'lines' [L, 2080], 'video_a' [L, 909],
    'video_b', 'offset', 'score'} (host sink)."""
    w = to_host(words).astype(np.float32).reshape(-1)
    off, score = apt_find_sync(w)
    w = w[off:]
    nl = w.size // WORDS_PER_LINE
    lines = w[: nl * WORDS_PER_LINE].reshape(nl, WORDS_PER_LINE)
    lay = apt_line_layout()
    a0, aw = lay["video_a"]
    b0, bw = lay["video_b"]
    return {"lines": lines, "video_a": lines[:, a0: a0 + aw], "video_b": lines[:, b0: b0 + bw],
            "offset": off, "score": score}


def apt_decode_mpx(params: AptParams, mpx) -> dict:
    """MPX f32 -> decoded image: envelope and words on the MPX's device
    (numpy goes to the taps' device), sync and slicing on the host."""
    return apt_decode_lines(params, apt_words(params, apt_envelope(params, mpx)))
