"""ACARS (aircraft datalink) over MSK audio (counterpart of
``srcdsp_tpu/chains/acars.py``).

Physical layer: 2400 bd MSK on an AM voice channel, 1200 Hz for '1' and
2400 Hz for '0' (CPFSK h = 0.5 centred at 1800 Hz); no NRZI, so the
discriminator's sign gives the bit (below centre = '1'). Characters: 8 bits
LSB first, bit 8 odd parity. Frame: pre-key, '+' '*' SYN SYN, SOH, mode,
address (7), technical ack, label (2), block id, STX, text, ETX/ETB, the
16-bit BCS (reflected CRC-16 0x1021, zero init, over the bytes after SOH
through the terminator, LSB first), DEL.

The FSK chain runs on the capture's device; the sync correlation and the
parser are host code on one copy of the bits. The BCS is a host spec of the
``gf2`` engine (no device at import).
"""

from __future__ import annotations

import numpy as np
import torch

from srcdsp_tpu_torch.chains.fsk import complex_audio, fsk_capture_bits
from srcdsp_tpu_torch.device import to_host
from srcdsp_tpu_torch.gf2 import crc_init, crc_update, crc_value, make_crc

__all__ = ["char_bits", "bits_chars", "acars_bcs", "build_acars_frame", "parse_acars_chars",
           "acars_modulate", "demod_acars_bits", "decode_acars_audio",
           "SOH", "STX", "ETX", "ETB", "DEL", "SYN"]

SOH, STX, ETX, ETB, DEL, SYN = 0x01, 0x02, 0x03, 0x17, 0x7F, 0x16
_SYNC_CHARS = (ord("+"), ord("*"), SYN, SYN)

_BCS = make_crc(0x1021, 16, init=0, xorout=0, reflect=True)


def _with_parity(c: int) -> int:
    """7-bit char -> 8-bit on-air byte with odd parity in bit 8."""
    c &= 0x7F
    return c | (0x80 if bin(c).count("1") % 2 == 0 else 0)


def char_bits(chars) -> np.ndarray:
    """On-air bytes -> bit stream, LSB first (8 bits a char)."""
    ch = np.asarray(list(chars), np.int64)
    return ((ch[:, None] >> np.arange(8)) & 1).reshape(-1).astype(np.int32)


def bits_chars(bits) -> np.ndarray:
    """Bit stream (len % 8 == 0) -> on-air bytes, LSB first."""
    b = to_host(bits).astype(np.int64).reshape(-1, 8)
    return (b @ (1 << np.arange(8))).astype(np.int64)


def acars_bcs(chars) -> int:
    """Block check sequence: CRC-16/KERMIT over the on-air bytes, on the host."""
    b = torch.as_tensor(char_bits(chars))
    return int(crc_value(_BCS, crc_update(_BCS, crc_init(_BCS, device="cpu"), b)))


def build_acars_frame(text: bytes, mode: str = "2", address: str = ".N12345",
                      tak: int = 0x15, label: str = "H1", bid: str = "1",
                      prekey_bits: int = 128) -> np.ndarray:
    """Downlink block -> on-air bit stream (int32 0/1)."""
    if len(address) != 7 or len(label) != 2 or len(mode) != 1 or len(bid) != 1:
        raise ValueError("mode/address/label/bid must be 1/7/2/1 chars")
    body7 = ([ord(mode)] + [ord(c) for c in address] + [tak] + [ord(c) for c in label]
             + [ord(bid)] + [STX] + list(text) + [ETX])
    body = [_with_parity(c) for c in body7]
    bcs = acars_bcs(body)
    head = [_with_parity(c) for c in _SYNC_CHARS] + [_with_parity(SOH)]
    return np.concatenate([np.ones(prekey_bits, np.int32), char_bits(head), char_bits(body),
                           ((bcs >> np.arange(16)) & 1).astype(np.int32),
                           char_bits([_with_parity(DEL)])])


def parse_acars_chars(chars) -> dict | None:
    """On-air bytes from the char after SOH -> the parsed block, or None.
    Finds ETX/ETB, checks each char's parity and the BCS after it."""
    ch = to_host(chars).astype(np.int64)
    term = None
    for i, c in enumerate(ch[:512]):
        if (c & 0x7F) in (ETX, ETB):
            term = i
            break
    if term is None or term + 3 > ch.size or term < 13:
        return None
    if int(ch[12]) & 0x7F != STX:
        return None
    body = ch[: term + 1]
    par_bad = int(sum(1 for c in body if bin(int(c)).count("1") % 2 == 0))
    bcs_rx = int(ch[term + 1]) | (int(ch[term + 2]) << 8)
    ok = acars_bcs(body) == bcs_rx and par_bad == 0
    low = [int(c) & 0x7F for c in body]
    return {"mode": chr(low[0]), "address": "".join(map(chr, low[1:8])), "tak": low[8],
            "label": "".join(map(chr, low[9:11])), "bid": chr(low[11]),
            "text": bytes(low[13:term]).decode(errors="replace"),
            "parity_errors": par_bad, "bcs_ok": bool(ok)}


def acars_modulate(bits, sps: int, fs: float = 48000.0) -> np.ndarray:
    """Bit stream -> real MSK audio, continuous phase (host fixture):
    '1' = 1200 Hz, '0' = 2400 Hz, sps = fs / 2400."""
    b = to_host(bits).astype(np.int32)
    inst = np.repeat(np.where(b == 1, 1200.0 / fs, 2400.0 / fs), sps)
    return np.cos(2 * np.pi * np.cumsum(inst)).astype(np.float32)


def demod_acars_bits(audio, sps: int, fs: float = 48000.0, num_taps: int = 64,
                     device=None) -> torch.Tensor:
    """Real audio -> hard bits [N // sps] int32 on the capture's device (a
    numpy array goes to `device`, None = the card): the FSK chain centred at
    1800 Hz with its cutoff at 0.75x the bit rate, '1' below centre."""
    lv_hat = fsk_capture_bits(complex_audio(audio, device), 1800.0 / fs, num_taps,
                              0.75 * 2400.0 / fs, sps, 600.0 / fs)
    return (1 - lv_hat).to(torch.int32)


def decode_acars_audio(audio, sps: int, fs: float = 48000.0, max_blocks: int = 16,
                       device=None) -> list[dict]:
    """Real audio -> parsed ACARS blocks: the demod on the capture's device,
    then on the host the 40-bit sync + SOH correlation (<= 2 bit errors) at
    every bit offset and a parse of each hit."""
    bits = to_host(demod_acars_bits(audio, sps, fs, device=device))
    sig = char_bits([_with_parity(c) for c in _SYNC_CHARS] + [_with_parity(SOH)])
    if bits.size < sig.size + 8:
        return []
    pm = 1.0 - 2.0 * bits.astype(np.float32)
    tpl = 1.0 - 2.0 * sig.astype(np.float32)
    hits = np.where(np.correlate(pm, tpl, mode="valid") >= sig.size - 2 * 2)[0]
    out = []
    last = -40
    for h in hits:
        if h - last < 40:
            continue
        rest = bits[h + sig.size:]
        nch = rest.size // 8
        if nch < 16:
            continue
        rec = parse_acars_chars(bits_chars(rest[: nch * 8]))
        if rec is not None:
            rec["start_bit"] = int(h)
            out.append(rec)
            last = h
            if len(out) >= max_blocks:
                break
    return out
