"""Mode S / ADS-B downlink (counterpart of ``srcdsp_tpu/chains/adsb.py``):
pulse-position modulation and the Mode S CRC-24.

Format (1090 MHz): an 8 us preamble of four 0.5 us pulses at 0, 1.0, 3.5
and 4.5 us, then 56 or 112 data bits at 1 Mb/s, a pulse in the first half
of the bit cell for a 1; bits MSB-first; the last 24 are the parity, the
remainder of the message times x^24 mod 0x1FFF409, so a clean frame's
remainder is zero.

The reference is host numpy in float64 on magnitude samples; so is the port.
Every sink takes magnitudes from any device and copies them to the host
once. The CRC is the ``gf2`` engine on CPU tensors; the frame decoders check
all their candidates' CRCs in one batched call and then walk the candidates
in the reference's order, so they return what its one-at-a-time loop does.
"""

from __future__ import annotations

import numpy as np
import torch

from srcdsp_tpu_torch.device import to_host
from srcdsp_tpu_torch.gf2 import crc_init, crc_update, crc_value, make_crc

__all__ = ["modes_crc", "build_frame", "modulate", "detect_preambles", "slice_bits",
           "decode_frame", "decode_all_frames"]

_PREAMBLE_HALVES = (0, 2, 7, 9)
_PREAMBLE_LEN = 16

_CRC = make_crc(0x00FFF409, 24, init=0)


def _crcs(bits: np.ndarray) -> np.ndarray:
    """Mode S CRC-24 of each row of bits [..., N] (MSB-first), on the host."""
    b = torch.as_tensor(np.asarray(bits, np.int32))
    return crc_value(_CRC, crc_update(_CRC, crc_init(_CRC, device="cpu"), b)).numpy()


def modes_crc(bits) -> int:
    """Mode S CRC-24 of a bit sequence (MSB-first air order)."""
    return int(_crcs(to_host(bits).reshape(-1)))


def build_frame(payload_bits) -> np.ndarray:
    """88 (or 32) message bits -> 112 (56) air bits with the parity appended,
    so that `modes_crc(frame) == 0`."""
    payload_bits = to_host(payload_bits).astype(np.int32)
    if payload_bits.size not in (32, 88):
        raise ValueError("Mode S payload is 32 or 88 bits")
    rem = modes_crc(payload_bits)
    return np.concatenate([payload_bits, ((rem >> (23 - np.arange(24))) & 1).astype(np.int32)])


def modulate(frame_bits, sps_half: int = 1, amplitude: float = 1.0) -> np.ndarray:
    """Air bits -> magnitude waveform (preamble + PPM), [N] f32; sps_half
    samples per 0.5 us half-bit (1 at the classic 2 Msps)."""
    frame_bits = to_host(frame_bits).astype(np.int32)
    halves = np.zeros(_PREAMBLE_LEN + 2 * frame_bits.size, np.float32)
    halves[list(_PREAMBLE_HALVES)] = amplitude
    halves[_PREAMBLE_LEN + 2 * np.arange(frame_bits.size) + (frame_bits == 0)] = amplitude
    return np.repeat(halves, sps_half).astype(np.float32)


def _half_sums(mag, sps_half):
    n = mag.size // sps_half
    return mag[: n * sps_half].reshape(n, sps_half).sum(axis=1)


def detect_preambles(mag, sps_half: int = 1, thresh: float = 3.0) -> np.ndarray:
    """Candidate frame starts (sample indices), strongest first: preamble
    score (pulse halves minus quiet halves over the phase's median level) at
    every sample phase, local maxima above `thresh`."""
    mag = to_host(mag).astype(np.float64)
    quiet = sorted(set(range(_PREAMBLE_LEN)) - set(_PREAMBLE_HALVES))
    cands: list[tuple[float, int]] = []
    for ph in range(sps_half):
        hs = _half_sums(mag[ph:], sps_half)
        if hs.size < _PREAMBLE_LEN + 4:
            continue
        floor = np.median(hs) + 1e-12
        n = hs.size - _PREAMBLE_LEN
        idx = np.arange(n)
        on = sum(hs[idx + h] for h in _PREAMBLE_HALVES) / len(_PREAMBLE_HALVES)
        off = sum(hs[idx + h] for h in quiet) / len(quiet)
        score = (on - off) / floor
        pad = np.concatenate([[-np.inf], score, [-np.inf]])
        peaks = np.where((score > thresh) & (score >= pad[:-2]) & (score >= pad[2:]))[0]
        cands.extend((float(score[p]), ph + int(p) * sps_half) for p in peaks)
    cands.sort(reverse=True)
    return np.asarray([c[1] for c in cands], np.int64)


def slice_bits(mag, start: int, nbits: int = 112, sps_half: int = 1) -> np.ndarray | None:
    """PPM-slice `nbits` after the preamble starting at sample `start`; None
    when the stream is too short."""
    return _slice(to_host(mag).astype(np.float64), start, nbits, sps_half)


def _slice(mag: np.ndarray, start: int, nbits: int, sps_half: int) -> np.ndarray | None:
    d0 = start + _PREAMBLE_LEN * sps_half
    need = d0 + 2 * nbits * sps_half
    if mag.size < need:
        return None
    hs = mag[d0: need].reshape(nbits, 2, sps_half).sum(axis=2)
    return (hs[:, 0] > hs[:, 1]).astype(np.int32)


def _sliced(mag: np.ndarray, starts: np.ndarray, nbits: int, sps_half: int):
    """(bits [K, nbits], crc [K]) of the starts whose frame fits, and their mask."""
    fits = starts + (_PREAMBLE_LEN + 2 * nbits) * sps_half <= mag.size
    rows = [_slice(mag, int(s), nbits, sps_half) for s in starts[fits]]
    bits = np.stack(rows) if rows else np.zeros((0, nbits), np.int32)
    return bits, (_crcs(bits) if rows else np.zeros(0, np.int64)), fits


def decode_frame(mag, sps_half: int = 1, nbits: int = 112, thresh: float = 3.0):
    """One Mode S frame from a magnitude capture: (bits | None, crc_ok,
    start); the first CRC-clean candidate wins, else the first sliced one."""
    mag = to_host(mag).astype(np.float64)
    starts = detect_preambles(mag, sps_half, thresh)
    bits, crc, fits = _sliced(mag, starts, nbits, sps_half)
    if not bits.shape[0]:
        return None, False, -1
    sel = starts[fits]
    clean = np.flatnonzero(crc == 0)
    if clean.size:
        return bits[clean[0]], True, int(sel[clean[0]])
    return bits[0], False, int(sel[0])


def decode_all_frames(mag, sps_half: int = 1, nbits: int = 112,
                      thresh: float = 3.0) -> list[tuple[np.ndarray, int]]:
    """All CRC-clean frames, [(bits, start)] in stream order, one per
    preamble neighbourhood (candidates within half a frame of an accepted
    start are the same burst)."""
    mag = to_host(mag).astype(np.float64)
    starts = detect_preambles(mag, sps_half, thresh)
    span = (2 * nbits + _PREAMBLE_LEN) * sps_half // 2
    bits, crc, fits = _sliced(mag, starts, nbits, sps_half)
    row = np.cumsum(fits) - 1
    out: list[tuple[np.ndarray, int]] = []
    taken = np.zeros(0, np.int64)
    for i, s in enumerate(int(v) for v in starts):
        if not fits[i] or crc[row[i]] != 0:
            continue
        k = int(np.searchsorted(taken, s))
        if (k < taken.size and taken[k] - s < span) or (k and s - taken[k - 1] < span):
            continue
        out.append((bits[row[i]], s))
        taken = np.insert(taken, k, s)
    out.sort(key=lambda t: t[1])
    return out
