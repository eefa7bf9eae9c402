"""SSTV (slow-scan television), Martin M1 (counterpart of
``srcdsp_tpu/chains/sstv.py``).

Audio FM: 1500 Hz black, 2300 Hz white, 1200 Hz sync. A transmission is the
calibration header (1900 Hz 300 ms, 1200 Hz 10 ms, 1900 Hz 300 ms), the VIS
code (1200 Hz start 30 ms, 7 bits LSB first at 30 ms, 1100 Hz = '1', 1300 Hz
= '0', even parity, 1200 Hz stop; Martin M1 is 44), then 256 lines of a
4.862 ms sync, a 0.572 ms porch and the G, B, R scans of 146.432 ms over
320 px, each followed by a 0.572 ms separator.

The instantaneous frequency (mix at 1900 Hz from the reference's float64
host phase, the "same" lowpass of `ops.fir.convolve_same`, the one-sample
discriminator) runs on the audio's device; the VIS gate, the per-line sync
search and the pixel integrate-and-dump run on the host, on one copy.

Repaired in the port: the reference sums each scan's pixels with
`np.add.reduceat(f, edges[:-1])`, which takes the last pixel's segment to
the end of the stream, so that pixel saturates. The port reduces over all
W + 1 edges and drops the last sum, so the last pixel is the mean of its own
segment [edges[-2], edges[-1]); every other pixel is the reference's.
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

__all__ = ["SstvParams", "make_sstv_params", "MARTIN_M1_VIS", "sstv_schedule", "sstv_modulate",
           "sstv_inst_freq", "sstv_decode_vis", "sstv_decode", "pixel_means"]

MARTIN_M1_VIS = 44
_F_BLACK, _F_WHITE, _F_SYNC = 1500.0, 2300.0, 1200.0
_F_LEADER = 1900.0
_BIT1, _BIT0 = 1100.0, 1300.0
_LINE_SYNC_S = 4.862e-3
_PORCH_S = 0.572e-3
_SCAN_S = 146.432e-3
_WIDTH, _HEIGHT = 320, 256


class SstvParams(NamedTuple):
    fs: float
    width: int
    height: int
    lp_taps: torch.Tensor    # [taps] float32 analytic-select lowpass on a device


def make_sstv_params(fs: float = 11025.0, width: int = _WIDTH, height: int = _HEIGHT,
                     taps: int = 127, device=None) -> SstvParams:
    """fs > 5400 Hz (the 1100..2700 Hz band around the 1900 Hz centre stays
    below Nyquist); raises otherwise. Taps on `device` (the card unless it
    says otherwise)."""
    if fs <= 5400.0:
        raise ValueError(f"fs {fs} too low for the 1100..2700 Hz band")
    return SstvParams(fs=float(fs), width=int(width), height=int(height),
                      lp_taps=torch.as_tensor(lowpass(taps, 800.0 / fs), device=resolve(device)))


def _vis_bits(code: int) -> list[int]:
    b = [(code >> i) & 1 for i in range(7)]
    return b + [sum(b) % 2]


def sstv_schedule(params: SstvParams, image, vis: int = MARTIN_M1_VIS):
    """Image [H, W, 3] in [0, 1] -> [(freq_hz, duration_s)]; scans G, B, R."""
    img = to_host(image).astype(np.float64)
    if img.shape != (params.height, params.width, 3):
        raise ValueError(f"image must be [{params.height}, {params.width}, 3], got {img.shape}")
    seg = [(_F_LEADER, 0.300), (_F_SYNC, 0.010), (_F_LEADER, 0.300), (_F_SYNC, 0.030)]
    seg += [(_BIT1 if b else _BIT0, 0.030) for b in _vis_bits(vis)]
    seg.append((_F_SYNC, 0.030))
    px = _SCAN_S / params.width
    for row in range(params.height):
        seg += [(_F_SYNC, _LINE_SYNC_S), (_F_BLACK, _PORCH_S)]
        for ch in (1, 2, 0):
            seg += [(_F_BLACK + (_F_WHITE - _F_BLACK) * float(v), px) for v in img[row, :, ch]]
            seg.append((_F_BLACK, _PORCH_S))
    return seg


def sstv_modulate(params: SstvParams, image, vis: int = MARTIN_M1_VIS) -> np.ndarray:
    """Image -> real audio f32, continuous phase (host fixture); segments
    round to the sample grid by cumulative time."""
    seg = sstv_schedule(params, image, vis)
    fs = params.fs
    ends = np.round(np.cumsum(np.asarray([d for _, d in seg])) * fs).astype(np.int64)
    freqs = np.asarray([f for f, _ in seg]) / fs
    inst = np.repeat(freqs, np.diff(np.concatenate([[0], ends])))
    return np.cos(2 * np.pi * np.mod(np.cumsum(inst), 1.0)).astype(np.float32)


def sstv_inst_freq(params: SstvParams, audio) -> torch.Tensor:
    """Real audio -> instantaneous frequency in Hz [N] on the audio's device
    (a numpy array goes to the taps' device): mix at 1900 Hz, the "same"
    lowpass of each plane, angle(z[n] conj z[n-1]), the first value repeated."""
    x = as_tensor_on(audio, params.lp_taps.device, F32)
    ph = torch.as_tensor(host_phase(_F_LEADER / params.fs, x.shape[-1]), device=x.device)
    h = params.lp_taps.to(x.device)
    z = torch.complex(convolve_same(x * torch.cos(ph), h), convolve_same(x * -torch.sin(ph), h))
    f = torch.angle(z[1:] * torch.conj(z[:-1])) * np.float32(params.fs / (2 * np.pi)) \
        + np.float32(_F_LEADER)
    return torch.cat([f[:1], f])


def _seg_mean(f: np.ndarray, t0: float, dur: float, fs: float) -> float:
    s0 = int(round(t0 * fs))
    s1 = max(s0 + 1, int(round((t0 + dur) * fs)))
    s0 = max(0, min(s0, f.size - 1))
    return float(f[s0:min(s1, f.size)].mean())


def sstv_decode_vis(params: SstvParams, f):
    """Instantaneous frequency (any device) -> (vis code | None, t_end)
    (host sink): the leader's long 1900 Hz run, then the 30 ms VIS slots
    searched over its tail; t_end is where the image lines begin."""
    f = to_host(f).astype(np.float32).reshape(-1)
    fs = params.fs
    k = int(0.010 * fs)
    box = np.convolve((np.abs(f - _F_LEADER) < 120.0).astype(np.float64),
                      np.ones(2 * k + 1) / (2 * k + 1), mode="same")
    idx = np.flatnonzero(box > 0.7)
    if idx.size == 0:
        return None, 0.0
    t0 = idx[0] / fs
    for dt in np.arange(0.55, 0.75, 0.005):
        ts = t0 + dt
        if abs(_seg_mean(f, ts + 0.005, 0.020, fs) - _F_SYNC) > 80:
            continue
        bits = []
        for i in range(8):
            fb = _seg_mean(f, ts + 0.030 * (i + 1) + 0.005, 0.020, fs)
            if abs(fb - _BIT1) < 80:
                bits.append(1)
            elif abs(fb - _BIT0) < 80:
                bits.append(0)
            else:
                bits = None
                break
        if bits is None:
            continue
        if abs(_seg_mean(f, ts + 0.030 * 9 + 0.005, 0.020, fs) - _F_SYNC) > 80:
            continue
        if sum(bits[:7]) % 2 != bits[7]:
            continue
        return sum(b << i for i, b in enumerate(bits[:7])), ts + 0.030 * 10
    return None, 0.0


def pixel_means(f: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """Mean of f over each [edges[i], edges[i+1]) (reduceat's rule where an
    edge does not advance: the one sample at it)."""
    sums = np.add.reduceat(f, edges)[:-1]
    return sums / np.maximum(np.diff(edges), 1)


def sstv_decode(params: SstvParams, audio, vis_required: bool = True):
    """Real audio -> {'image' [H, W, 3], 'vis', 'ok'}: the instantaneous
    frequency on the audio's device, then on the host the VIS gate and, per
    line, the sync's falling edge searched around its expected time (+-8 ms
    on line 0, +-2 ms after) and each scan's pixels averaged over their
    slots."""
    f = to_host(sstv_inst_freq(params, audio))
    fs = params.fs
    vis, t = sstv_decode_vis(params, f)
    if vis is None:
        if vis_required:
            return {"image": None, "vis": None, "ok": False}
        t = 0.0
    img = np.zeros((params.height, params.width, 3), np.float32)
    px = _SCAN_S / params.width
    line_s = _LINE_SYNC_S + _PORCH_S + 3 * (_SCAN_S + _PORCH_S)
    ns_h = int(0.002 * fs)
    np_p = max(1, int(_PORCH_S * fs))
    for row in range(params.height):
        win = int((0.008 if row == 0 else 0.002) * fs)
        s_exp = int(round((t + _LINE_SYNC_S) * fs))
        best, best_s = None, s_exp
        for s in range(max(ns_h, s_exp - win), s_exp + win + 1):
            if s + np_p > f.size:
                break
            m = (float(np.abs(f[s - ns_h: s] - _F_SYNC).mean())
                 + float(np.abs(f[s: s + np_p] - _F_BLACK).mean()))
            if best is None or m < best:
                best, best_s = m, s
        t_line = best_s / fs - _LINE_SYNC_S
        for ci, ch in enumerate((1, 2, 0)):
            t_scan = t_line + _LINE_SYNC_S + _PORCH_S + ci * (_SCAN_S + _PORCH_S)
            edges = np.round((t_scan + np.arange(params.width + 1) * px) * fs).astype(np.int64)
            edges = np.clip(edges, 0, f.size - 1)
            img[row, :, ch] = (pixel_means(f, edges) - _F_BLACK) / (_F_WHITE - _F_BLACK)
        t = t_line + line_s
    return {"image": np.clip(img, 0.0, 1.0), "vis": vis, "ok": True}
