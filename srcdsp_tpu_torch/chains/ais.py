"""AIS (ITU-R M.1371) frame layer (counterpart of ``srcdsp_tpu/chains/ais.py``):
NRZI line coding, HDLC flags and bit stuffing (``hdlc``) and the X-25 FCS
(CRC-16, poly 0x1021 reflected, init/xorout 0xFFFF) through the ``gf2``
engine. Air order: bytes LSB-first, the FCS LSB-first of its 16-bit value;
NRZI-S (a 0 toggles the level, a 1 holds it), so only transitions matter.

The frame decoders are host sinks: the demodulated levels are copied to the
host once, NRZI-decoded, and searched there. They return what the
reference's candidate-flag-pair loops return, the first FCS-clean pair (and,
for `decode_ais_frame`, the best-formed failure), without destuffing and
CRC-checking every pair, which on a noisy minute is millions of pairs:

- the stuffed zeros are marked once over the whole stream: a span always
  starts right after a flag, whose last bit is 0, so the run of ones there is
  0 and the global marks equal the span's own;
- an FCS-clean body (payload, then its FCS) leaves the CRC register at one
  fixed residue R. With W = A^-1 of the register's GF(2) map, the register
  after destuffed bits d[i:k] from init S0 equals R exactly when
  key_end[k] = W^k R + P_k equals key_start[i] = W^i S0 + P_i, where
  P_k = sum over t < k of W^(t+1) B d_t (all mod 2). Both keys are numpy
  prefix arrays over the stream, so each start finds its clean ends by one
  dictionary lookup.

Module constants are host specs (``gf2.make_crc`` touches no device), so the
module imports on a machine with no card.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from srcdsp_tpu_torch.device import to_host
from srcdsp_tpu_torch.gf2 import bytes_to_bits, crc_init, crc_update, crc_value, make_crc
from srcdsp_tpu_torch.hdlc import FLAG, compact_bits, destuff_bits, find_flags, stuff_bits

__all__ = ["TRAINING", "ais_fcs", "nrzi_encode", "nrzi_decode", "build_hdlc_air_bits",
           "build_ais_frame", "decode_ais_frame", "decode_all_ais_frames"]

_FCS = make_crc(0x1021, 16, init=0xFFFF, xorout=0xFFFF, reflect=True)

TRAINING = np.tile([0, 1], 12).astype(np.int32)       # 24-bit preamble


def ais_fcs(bits) -> int:
    """X-25 FCS over air bits (LSB-first per byte), on the host."""
    b = torch.as_tensor(to_host(bits).astype(np.int32))
    return int(crc_value(_FCS, crc_update(_FCS, crc_init(_FCS, device="cpu"), b)))


def nrzi_encode(bits, level0: int = 0) -> np.ndarray:
    """NRZI-S: a 0 toggles the level, a 1 holds it (a cumulative XOR)."""
    bits = to_host(bits).astype(np.int32)
    lvl = (level0 + np.cumsum(1 - bits)) % 2
    return lvl.astype(np.int32)


def nrzi_decode(levels) -> np.ndarray:
    """Levels -> bits: 1 where the level held, 0 where it toggled (host)."""
    lv = to_host(levels).astype(np.int32).reshape(-1)
    d = np.concatenate([[lv[0]], lv])
    return (1 - (d[1:] ^ d[:-1])).astype(np.int32)


def build_hdlc_air_bits(payload: bytes) -> np.ndarray:
    """Payload bytes -> pre-NRZI air bits: flag | stuffed(payload + FCS) | flag."""
    pb = bytes_to_bits(payload, lsb_first=True)
    fcs = ais_fcs(pb)
    fcs_bits = ((fcs >> np.arange(16)) & 1).astype(np.int32)
    ob, vb, _ = stuff_bits(torch.as_tensor(np.concatenate([pb, fcs_bits])))
    return np.concatenate([FLAG, compact_bits(ob, vb), FLAG]).astype(np.int32)


def build_ais_frame(payload: bytes, level0: int = 0) -> np.ndarray:
    """Payload bytes -> NRZI line levels: training | flag | stuffed | flag."""
    air = np.concatenate([TRAINING, build_hdlc_air_bits(payload)])
    return nrzi_encode(air.astype(np.int32), level0)


# ---------------------------------------------------------------------------
# GF(2) register algebra on 16-bit ints (bit i = register bit s_i)
# ---------------------------------------------------------------------------

def _cols(m: np.ndarray) -> np.ndarray:
    """Matrix [p, p] over GF(2) -> the images of the basis vectors as ints."""
    return (m.astype(np.int64) << np.arange(m.shape[0])[:, None]).sum(axis=0)


def _apply(cols: np.ndarray, v: np.ndarray) -> np.ndarray:
    out = np.zeros_like(v)
    for j, c in enumerate(cols):
        out ^= ((v >> j) & 1) * c
    return out


def _gf2_inv(a: np.ndarray) -> np.ndarray:
    p = a.shape[0]
    m = np.concatenate([a.astype(np.uint8) & 1, np.eye(p, dtype=np.uint8)], axis=1)
    for c in range(p):
        r = c + int(np.flatnonzero(m[c:, c])[0])
        m[[c, r]] = m[[r, c]]
        for rr in np.flatnonzero(m[:, c]):
            if rr != c:
                m[rr] ^= m[c]
    return m[:, p:]


def _powers(w: np.ndarray, v: int, n: int) -> np.ndarray:
    """[W^k v for k in 0..n-1] by doubling: g[m:2m] = W^m g[0:m]."""
    g = np.zeros(max(n, 1), np.int64)
    g[0] = v
    m, wm = 1, w.copy()
    while m < n:
        g[m:min(2 * m, n)] = _apply(_cols(wm), g[:min(m, n - m)])
        wm = (wm.astype(np.int64) @ wm) % 2
        m *= 2
    return g[:n]


@functools.lru_cache(maxsize=None)
def _register():
    """(W = A^-1, B as an int, S0, the FCS-clean residue R)."""
    mach = _FCS.machine
    w = _gf2_inv(mach.a).astype(np.int64)
    b = int(_cols(mach.b[:, None])[0])
    s0 = int(_FCS.init)
    body = bytes_to_bits(b"\x5a", lsb_first=True)
    fcs = ais_fcs(body)
    full = np.concatenate([body, (fcs >> np.arange(16)) & 1]).astype(np.int32)
    s = crc_update(_FCS, crc_init(_FCS, device="cpu"), torch.as_tensor(full))
    r = int((torch.round(s).to(torch.int64) << torch.arange(16)).sum())
    return w, b, s0, r


class _Search:
    """One NRZI-decoded stream: flag hits, destuffed bits and the CRC keys."""

    def __init__(self, levels):
        self.bits = bits = nrzi_decode(levels)
        t = torch.as_tensor(bits)
        self.hits = np.flatnonzero(find_flags(t).numpy())
        _, keep, _ = destuff_bits(t)
        keep = keep.numpy()
        self.cum = np.concatenate([[0], np.cumsum(keep)])
        self.d = bits[keep].astype(np.int64)
        m = self.d.size
        w, b, s0, r = _register()
        wb = _powers(w, b, m + 1)[1:]                        # W^(t+1) B
        p = np.concatenate([[0], np.bitwise_xor.accumulate(wb * self.d)]) if m else np.zeros(1, np.int64)
        self.key_start = _powers(w, s0, m + 1) ^ p
        key_end = _powers(w, r, m + 1) ^ p
        self.clean: dict[int, list[int]] = {}
        for j, e in enumerate(self.hits):
            self.clean.setdefault(int(key_end[self.cum[e]]), []).append(j)

    def sized(self, start: int, ends: np.ndarray) -> np.ndarray:
        """Which (start, end) pairs pass the reference's size checks."""
        body = self.cum[ends] - self.cum[start + 8]
        return (ends - start - 8 >= 24) & (body >= 24) & ((body - 16) % 8 == 0)

    def first_clean(self, start: int, j0: int, j1: int) -> int | None:
        """Index of the first hit in [j0, j1) that closes an FCS-clean frame."""
        lst = self.clean.get(int(self.key_start[self.cum[start + 8]]), ())
        for j in lst[int(np.searchsorted(lst, j0)):]:
            if j >= j1:
                break
            if self.sized(start, self.hits[j:j + 1])[0]:
                return j
        return None

    def payload(self, start: int, end: int) -> bytes:
        pb = self.d[self.cum[start + 8]: self.cum[end] - 16]
        return np.packbits(pb.reshape(-1, 8)[:, ::-1]).tobytes()

    def ends(self, start: int, max_ends: int | None) -> tuple[int, int]:
        j0 = int(np.searchsorted(self.hits, start + 8, side="right"))
        return j0, self.hits.size if max_ends is None else min(self.hits.size, j0 + max_ends)


def decode_ais_frame(levels, max_ends_per_start: int | None = None):
    """Demodulated line levels (any device) -> (payload bytes | None, fcs_ok,
    flag_index). Host sink: of every (start flag, end flag) pair in stream
    order, the first FCS-clean one wins; else the first well-formed failure
    is reported. `max_ends_per_start` bounds the end flags tried per start."""
    s = _Search(levels)
    if s.hits.size < 2:
        return None, False, -1
    best = (None, False, int(s.hits[0]))
    for start in (int(h) for h in s.hits):
        j0, j1 = s.ends(start, max_ends_per_start)
        if best[0] is None:
            ok = np.flatnonzero(s.sized(start, s.hits[j0:j1]))
            if ok.size:
                end = int(s.hits[j0 + ok[0]])
                if s.first_clean(start, j0, j0 + ok[0] + 1) is None:
                    best = (s.payload(start, end), False, start)
        j = s.first_clean(start, j0, j1)
        if j is not None:
            return s.payload(start, int(s.hits[j])), True, start
    return best


def decode_all_ais_frames(levels, max_ends_per_start: int | None = None
                          ) -> list[tuple[bytes, int]]:
    """Every FCS-clean frame in the capture, in stream order, as
    [(payload bytes, start_flag_index)] (host sink). Candidate ends are taken
    nearest first; after a frame the scan resumes at its closing flag, which
    may open the next (back-to-back AIS shares one flag)."""
    s = _Search(levels)
    out: list[tuple[bytes, int]] = []
    hi = 0
    while hi < s.hits.size:
        start = int(s.hits[hi])
        j = s.first_clean(start, *s.ends(start, max_ends_per_start))
        if j is None:
            hi += 1
            continue
        out.append((s.payload(start, int(s.hits[j])), start))
        hi = j
    return out
