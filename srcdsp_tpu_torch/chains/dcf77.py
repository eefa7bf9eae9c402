"""DCF77 time-signal decoding (counterpart of ``srcdsp_tpu/chains/dcf77.py``).

The 77.5 kHz carrier drops to 15 % at the start of every second for 100 ms
(bit 0) or 200 ms (bit 1); second 59 has no drop and marks the minute.
Frame: bit 0 = 0, 17/18 the CEST/CET flags, 20 = 1, minute BCD 21-27 with
even parity 28, hour 29-34 with parity 35, day 36-41, weekday 42-44, month
45-49, year in century 50-57, parity 58 over 36-57. The reference is pure
numpy; the port keeps its own copy, and the envelope may be a tensor on any
device (copied to the host once).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from srcdsp_tpu_torch.device import to_host

__all__ = ["Dcf77Time", "dcf77_encode_minute", "dcf77_decode_minute", "dcf77_modulate",
           "dcf77_envelope_bits", "dcf77_decode"]


class Dcf77Time(NamedTuple):
    minute: int
    hour: int
    day: int
    weekday: int
    month: int
    year2: int              # year in century, 0-99
    cest: bool              # summer time flag (bit 17)


def _bcd(v: int, nbits: int) -> list[int]:
    code = (v % 10) | ((v // 10) << 4)
    return [(code >> i) & 1 for i in range(nbits)]


def _unbcd(bits) -> int:
    code = sum(int(b) << i for i, b in enumerate(bits))
    return (code & 0xF) + 10 * (code >> 4)


def dcf77_encode_minute(t: Dcf77Time) -> np.ndarray:
    """Time -> the 59 transmitted bits of one minute."""
    b = np.zeros(59, np.int64)
    b[17] = int(t.cest)
    b[18] = int(not t.cest)
    b[20] = 1
    b[21:28] = _bcd(t.minute, 7)
    b[28] = b[21:28].sum() % 2
    b[29:35] = _bcd(t.hour, 6)
    b[35] = b[29:35].sum() % 2
    b[36:42] = _bcd(t.day, 6)
    b[42:45] = [(t.weekday >> i) & 1 for i in range(3)]
    b[45:50] = _bcd(t.month, 5)
    b[50:58] = _bcd(t.year2, 8)
    b[58] = b[36:58].sum() % 2
    return b


def dcf77_decode_minute(bits) -> Dcf77Time | None:
    """59 bits -> Dcf77Time, or None if the structure or a parity fails."""
    b = to_host(bits).astype(np.int64).reshape(-1)
    if b.size != 59 or b[0] != 0 or b[20] != 1:
        return None
    if b[21:28].sum() % 2 != b[28] or b[29:35].sum() % 2 != b[35]:
        return None
    if b[36:58].sum() % 2 != b[58]:
        return None
    return Dcf77Time(minute=_unbcd(b[21:28]), hour=_unbcd(b[29:35]), day=_unbcd(b[36:42]),
                     weekday=int(sum(int(v) << i for i, v in enumerate(b[42:45]))),
                     month=_unbcd(b[45:50]), year2=_unbcd(b[50:58]), cest=bool(b[17]))


def dcf77_modulate(bits_minutes, fs: float = 1000.0, low: float = 0.15) -> np.ndarray:
    """Bit minutes ([59] each) -> AM envelope f32 (host fixture): `low` for
    100 ms (0) or 200 ms (1) at each second's start, second 59 full."""
    sps = int(round(fs))
    out = []
    for bits in bits_minutes:
        bits = to_host(bits).astype(np.int64)
        if bits.size != 59:
            raise ValueError("each minute must carry 59 bits")
        for b in bits:
            sec = np.full(sps, 1.0, np.float32)
            sec[: int((0.2 if b else 0.1) * fs)] = low
            out.append(sec)
        out.append(np.full(sps, 1.0, np.float32))
    return np.concatenate(out)


def dcf77_envelope_bits(env, fs: float = 1000.0):
    """AM envelope (any device) -> (bit values [K], second starts [K] in
    samples, minute marks: indices where a >= 1.8 s gap precedes, and 0).
    Threshold midway between the 5th and 95th percentiles; a second's bit
    is its total low time in 300 ms, >= 150 ms a 1."""
    env = to_host(env).astype(np.float64).reshape(-1)
    lo, hi = np.percentile(env, 5), np.percentile(env, 95)
    if hi - lo < 0.2 * hi:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), []
    low = env < 0.5 * (lo + hi)
    edges = np.flatnonzero(low[1:] & ~low[:-1]) + 1
    vals, starts = [], []
    w = int(0.30 * fs)
    last = -10 ** 9
    for e in edges:
        if e - last < 0.8 * fs:
            continue
        tot = int(low[e: e + w].sum())
        if tot < 0.05 * fs or tot > 0.28 * fs:
            continue
        vals.append(1 if tot >= 0.15 * fs else 0)
        starts.append(e)
        last = e
    vals = np.asarray(vals, np.int64)
    starts = np.asarray(starts, np.int64)
    marks = [i for i in range(1, starts.size) if starts[i] - starts[i - 1] > 1.8 * fs]
    if starts.size:
        marks = [0] + marks
    return vals, starts, marks


def dcf77_decode(env, fs: float = 1000.0):
    """AM envelope (any device) -> [Dcf77Time], one per complete,
    parity-clean minute (host sink)."""
    vals, _, marks = dcf77_envelope_bits(env, fs)
    out = []
    for m in marks:
        if m + 59 <= vals.size:
            t = dcf77_decode_minute(vals[m: m + 59])
            if t is not None:
                out.append(t)
    return out
