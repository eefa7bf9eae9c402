"""BLE-style GFSK advertising link (counterpart of ``srcdsp_tpu/chains/ble.py``).

Format (LE 1M uncoded PHY, advertising channel): preamble (8 alternating
bits) | access address (32 bits, LSB-first 0x8E89BED6) | PDU header (type,
length) | payload | CRC-24, header + payload + CRC whitened by the
x^7 + x^4 + 1 LFSR seeded 0x40 | channel; bytes LSB-first; CRC-24 poly
0x65B, preset 0x555555, emitted register bit 23 first.

The whitening machine and the CRC are host specs of the port's ``gf2``
engine (no device at import); the codec runs on the host, on CPU tensors.
`decode_adv_frame` is a host sink: it copies the demodulated bits to the host
once and tries the access-address candidates in the reference's order
(numpy's `argsort(...)[::-1]`, which fixes how ties are tried).
"""

from __future__ import annotations

import numpy as np
import torch

from srcdsp_tpu_torch.device import to_host
from srcdsp_tpu_torch.gf2 import (Gf2Machine, bytes_to_bits, crc_init, crc_update, crc_value,
                                  gf2_init, make_crc, scramble)

__all__ = ["ADV_ACCESS_ADDRESS", "ADV_CHANNELS", "access_address_bits", "preamble_bits",
           "whiten_bits", "crc24", "build_adv_frame", "decode_adv_frame"]

ADV_ACCESS_ADDRESS = 0x8E89BED6
ADV_CHANNELS = (37, 38, 39)

_CRC24 = make_crc(0x00065B, 24, init=0x555555)


def _whiten_machine() -> Gf2Machine:
    """The whitening register in Galois form (`whit = 0x40 | channel; out =
    whit & 1; whit >>= 1; if out: whit ^= 0x44`), state [r0..r6] LSB first:
    out = r0, r2' = r3 ^ r0, r6' = r0, the rest shift down."""
    a = np.zeros((7, 7), np.uint8)
    for i in range(6):
        a[i, i + 1] = 1
    a[2, 0] = 1                 # the 0x44 tap at bit 2
    a[6, 0] = 1                 # the 0x44 tap at bit 6
    c = np.zeros(7, np.uint8)
    c[0] = 1
    return Gf2Machine(a, np.zeros(7, np.uint8), c, 0, 512)


_WHITEN = _whiten_machine()


def access_address_bits(aa: int = ADV_ACCESS_ADDRESS) -> np.ndarray:
    """The 32 air bits of an access address (LSB-first of the 32-bit value)."""
    return ((np.uint32(aa) >> np.arange(32, dtype=np.uint32)) & 1).astype(np.int32)


def preamble_bits(aa: int = ADV_ACCESS_ADDRESS) -> np.ndarray:
    """8 alternating bits whose last differs from access-address bit 0."""
    last = 1 - (aa & 1)
    return np.asarray([(last if (7 - i) % 2 == 0 else 1 - last) for i in range(8)], np.int32)


def whiten_bits(bits, channel: int) -> np.ndarray:
    """Whiten (or de-whiten: self-inverse) air bits on the host; register
    seed 0x40 | channel, stored LSB first."""
    seed = [(channel >> i) & 1 for i in range(6)] + [1]
    s = gf2_init(_WHITEN, seed, device="cpu")
    _, out = scramble(_WHITEN, s, torch.as_tensor(to_host(bits).astype(np.int32)))
    return out.numpy().astype(np.int32)


def crc24(pdu_bits) -> np.ndarray:
    """CRC-24 over PDU air bits -> 24 air bits, register bit 23 first (host)."""
    b = torch.as_tensor(to_host(pdu_bits).astype(np.int32))
    val = int(crc_value(_CRC24, crc_update(_CRC24, crc_init(_CRC24, device="cpu"), b)))
    return ((val >> (23 - np.arange(24))) & 1).astype(np.int32)


def build_adv_frame(payload: bytes, channel: int = 37, pdu_type: int = 0x02,
                    aa: int = ADV_ACCESS_ADDRESS) -> np.ndarray:
    """The air bits of one advertising packet, [8 + 32 + (2 + len + 3) * 8]
    (pdu_type 0x02 = ADV_NONCONN_IND)."""
    if len(payload) > 255:
        raise ValueError("payload too long")
    pdu = bytes_to_bits(bytes([pdu_type & 0xFF, len(payload)]) + payload, lsb_first=True)
    pdu = np.concatenate([pdu, crc24(pdu)])
    return np.concatenate([preamble_bits(aa), access_address_bits(aa),
                           whiten_bits(pdu, channel)]).astype(np.int32)


def decode_adv_frame(bits, channel: int = 37, aa: int = ADV_ACCESS_ADDRESS,
                     max_aa_errors: int = 0):
    """Host sink: demodulated hard bits (any device) -> (payload bytes |
    None, crc_ok, aa_index), aa_index the offset of the first PDU bit. Every
    access-address candidate within `max_aa_errors` is tried, best
    correlation first; the first CRC-clean decode wins, else the best
    candidate's attempt is returned."""
    bits = to_host(bits).astype(np.int32).ravel()
    pat = 1.0 - 2.0 * access_address_bits(aa).astype(np.float64)
    sig = 1.0 - 2.0 * bits.astype(np.float64)
    if sig.size < pat.size + 40:
        return None, False, -1
    corr = np.correlate(sig, pat, mode="valid")
    cand = np.flatnonzero(corr >= 32 - 2 * max_aa_errors)
    if cand.size == 0:
        return None, False, -1
    cand = cand[np.argsort(corr[cand])[::-1]]

    def _try(idx):
        start = idx + 32
        avail = bits.size - start
        if avail < 40:
            return None, False, start
        w = whiten_bits(bits[start: start + avail], channel)
        length = int(np.packbits(w[8:16][::-1])[0])
        need = (2 + length + 3) * 8
        if avail < need:
            return None, False, start
        pdu = w[: (2 + length) * 8]
        ok = bool(np.array_equal(crc24(pdu), w[(2 + length) * 8: need]))
        payload = np.packbits(w[16: (2 + length) * 8].reshape(-1, 8)[:, ::-1]).tobytes()
        return payload, ok, start

    best = None
    for idx in cand:
        payload, ok, start = _try(int(idx))
        if ok:
            return payload, ok, start
        if best is None:
            best = (payload, ok, start)
    return best
