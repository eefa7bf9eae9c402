"""RDS (Radio Data System, EN 50067) (counterpart of ``srcdsp_tpu/chains/rds.py``).

Physical layer: BPSK on the 57 kHz subcarrier of the FM stereo MPX (3x the
19 kHz pilot), 1187.5 bps, biphase symbols and differential data. The
analytic pilot's unit phasor cubed is the 57 kHz reference, so the
demodulator is two complex bandpasses, a derotation and a boxcar matched
filter, on the capture's device; the bit-phase pick that follows is host
numpy on one copy of the filter output.

Block layer: groups of 4 x 26-bit blocks, 16 info bits + 10 check bits of
the shortened cyclic code g(x) = x^10 + x^8 + x^7 + x^5 + x^4 + x^3 + 1 plus
a per-position offset word; an error-free block's syndrome equals its offset
word, so block sync is the syndrome of every 26-bit window, one
[W, 26] x [26, 10] GF(2) product (float32, TF32 off), with single-bit
correction from a 26-entry table. The sync walk is host code.
"""

from __future__ import annotations

import numpy as np
import torch

from srcdsp_tpu_torch.chains.fsk import complex_audio
from srcdsp_tpu_torch.device import as_tensor_on, to_host
from srcdsp_tpu_torch.ops.fir import fir_full, pin_f32
from srcdsp_tpu_torch.ops.window import lowpass
from srcdsp_tpu_torch.types import F32

__all__ = ["rds_checkword", "rds_encode_group", "rds_syndromes", "rds_sync_decode",
           "rds_baseband", "rds_inject_mpx", "rds_demod_mpx", "OFFSETS"]

_G = 0x1B9          # g(x) minus the x^10 term, MSB = x^9 coefficient
_DEG = 10
OFFSETS = {"A": 0x0FC, "B": 0x198, "C": 0x168, "Cp": 0x350, "D": 0x1B4}


def _mod_g(poly_bits) -> np.ndarray:
    """Long-division remainder of an MSB-first bit vector mod g(x)."""
    r = 0
    for b in np.asarray(poly_bits, int):
        r = (r << 1) | int(b)
        if r & (1 << _DEG):
            r ^= (1 << _DEG) | _G
    return np.asarray([(r >> (9 - i)) & 1 for i in range(10)], np.int32)


def _xpow_mod_g(k: int) -> np.ndarray:
    v = np.zeros(k + 1, np.int32)
    v[0] = 1
    return _mod_g(v)


# [26, 10] syndrome matrix, row i = x^(25-i) mod g; [16, 10] checkword generator
_S = np.stack([_xpow_mod_g(25 - i) for i in range(26)])
_GEN = _S[:16]


def _bits_to_int(bits: np.ndarray) -> np.ndarray:
    w = (1 << np.arange(bits.shape[-1] - 1, -1, -1)).astype(np.int64)
    return np.asarray(bits, np.int64) @ w


_E1 = {int(_bits_to_int(_S[i])): i for i in range(26)}


def rds_checkword(info: int) -> int:
    """10-bit checkword of a 16-bit info word (before the offset)."""
    m = np.asarray([(info >> (15 - i)) & 1 for i in range(16)], np.int32)
    return int(_bits_to_int((m @ _GEN) % 2))


def rds_encode_group(words, version: str = "A") -> np.ndarray:
    """4 x 16-bit info words -> 104 air bits (MSB first per block); version
    'A' uses offsets A, B, C, D, 'B' uses A, B, C', D."""
    seq = ["A", "B", "C" if version == "A" else "Cp", "D"]
    out = []
    for w, off in zip(words, seq):
        c = rds_checkword(int(w)) ^ OFFSETS[off]
        out += [(int(w) >> (15 - i)) & 1 for i in range(16)]
        out += [(c >> (9 - i)) & 1 for i in range(10)]
    return np.asarray(out, np.int32)


def rds_syndromes(bits, device=None) -> np.ndarray:
    """All sliding 26-bit window syndromes, [N-25] ints in [0, 1024): one
    GF(2) product on the bits' device (a numpy array goes to `device`, None
    = the card)."""
    b = as_tensor_on(bits, device, F32).reshape(-1)
    if b.shape[-1] < 26:
        return np.zeros((0,), np.int64)
    pin_f32(b)
    syn = torch.remainder(b.unfold(0, 26, 1) @ torch.as_tensor(_S, dtype=F32, device=b.device),
                          2.0)
    return _bits_to_int(to_host(syn).astype(np.int64))


def _try_block(bits26: np.ndarray, offset: int):
    """-> (info16 or None, corrected bits)."""
    e = int(_bits_to_int((np.asarray(bits26, np.int64) @ _S) % 2)) ^ offset
    if e == 0:
        return int(_bits_to_int(bits26[:16])), 0
    pos = _E1.get(e)
    if pos is not None:
        fixed = np.asarray(bits26, np.int32).copy()
        fixed[pos] ^= 1
        return int(_bits_to_int(fixed[:16])), 1
    return None, 0


def rds_sync_decode(bits, max_groups: int | None = None):
    """Bit stream (any device) -> decoded groups [{start, version, words
    [4], corrected}] (host sink): block sync where a window's syndrome is
    offset A (or one bit from it), then B, C/C', D at 26-bit spacing."""
    bits = to_host(bits).astype(np.int32).reshape(-1)
    syn = rds_syndromes(bits, device="cpu")
    groups = []
    pos = 0
    limit = bits.size - 104 + 1
    ea = syn[:max(0, limit)] ^ OFFSETS["A"]
    starts = np.flatnonzero(np.isin(ea, np.array([0] + sorted(_E1), np.int64)))
    for p in starts:
        if p < pos:
            continue
        a, ca = _try_block(bits[p: p + 26], OFFSETS["A"])
        if a is None:
            continue
        b, cb = _try_block(bits[p + 26: p + 52], OFFSETS["B"])
        if b is None:
            continue
        c, cc = _try_block(bits[p + 52: p + 78], OFFSETS["C"])
        version = "A"
        if c is None:
            c, cc = _try_block(bits[p + 52: p + 78], OFFSETS["Cp"])
            version = "B"
        d, cd = _try_block(bits[p + 78: p + 104], OFFSETS["D"])
        if None in (a, c, d):
            continue
        groups.append({"start": int(p), "version": version, "words": [a, b, c, d],
                       "corrected": ca + cb + cc + cd})
        pos = p + 104
        if max_groups and len(groups) >= max_groups:
            break
    return groups


def rds_baseband(bits, sps_half: int) -> np.ndarray:
    """Air bits -> real biphase baseband at sps_half samples a half-bit
    (differential encode, then (+,-) / (-,+) half pairs); host fixture."""
    d = np.bitwise_xor.accumulate(to_host(bits).astype(np.int32)) % 2
    lv = 1.0 - 2.0 * d
    return np.repeat(np.stack([lv, -lv], axis=1).reshape(-1).astype(np.float32), sps_half)


def rds_inject_mpx(mpx, bits, f_pilot: float, sps_half: int, level: float = 0.06) -> np.ndarray:
    """Add the pilot-coherent RDS subcarrier to a composite MPX fixture."""
    bb = rds_baseband(bits, sps_half)
    mpx = to_host(mpx)
    n = min(len(mpx), len(bb))
    out = np.asarray(mpx, np.float64).copy()
    out[:n] += level * bb[:n] * np.cos(2 * np.pi * 3 * f_pilot * np.arange(n))
    return out.astype(np.float32)


def _bandpass(ntaps: int, cutoff: float, center: float) -> np.ndarray:
    nn = np.arange(ntaps) - (ntaps - 1) / 2.0
    return (lowpass(ntaps, cutoff) * np.exp(2j * np.pi * center * nn)).astype(np.complex64)


def rds_demod_mpx(mpx, f_pilot: float, sps_half: int, ntaps: int = 257,
                  bw_frac: float = 1.2, device=None) -> np.ndarray:
    """MPX (a numpy array goes to `device`, None = the card; a tensor stays
    where it is) -> RDS air bits, numpy (polarity-immune). On the device:
    the pilot and 57 kHz bandpasses, carrier (pilot / |pilot|)^3, derotation
    and the half-bit boxcar; on the host: the biphase correlator, the
    bit-grid phase of largest energy, slicing, differential decode."""
    x = complex_audio(mpx, device)
    pil = fir_full(_bandpass(ntaps, f_pilot * 0.1, f_pilot), x)
    sub = fir_full(_bandpass(ntaps, bw_frac / (2.0 * sps_half), 3 * f_pilot), x)
    u = pil / (torch.abs(pil) + np.float32(1e-12))
    bb = torch.real(sub * torch.conj(u * u * u)).contiguous()
    box = np.ones(sps_half, np.float32) / np.float32(sps_half)
    y = to_host(torch.real(fir_full(box, bb)))
    sb = 2 * sps_half
    nbit = (y.size - sps_half) // sb - 1
    if nbit < 26:
        raise ValueError("capture too short for RDS")
    zg = (y[: nbit * sb] - y[sps_half: sps_half + nbit * sb]).reshape(nbit, sb)
    p = int(np.argmax(np.abs(zg).sum(axis=0)))
    d = (zg[:, p] < 0).astype(np.int32)
    return np.bitwise_xor(d[1:], d[:-1]).astype(np.int32)
