"""SAME / EAS (the US Emergency Alert System header) (counterpart of
``srcdsp_tpu/chains/same.py``).

AFSK at 520.83 Bd: mark 2083 1/3 Hz (4 cycles a bit), space 1562.5 Hz (3
cycles a bit); bytes LSB first, synchronous, after a 16-byte 0xAB preamble.
Header 'ZCZC-ORG-EEE-PSSCCC+TTTT-JJJHHMM-LLLLLLLL-', sent three times; the
end of message is preamble + 'NNNN'. The receiver runs the FSK chain centred
between the tones on the capture's device; the byte alignment (the 0xAB
pattern over all bit phases) and the ASCII read are host code on one copy.
"""

from __future__ import annotations

import numpy as np

from srcdsp_tpu_torch.chains.fsk import complex_audio, fsk_capture_bits
from srcdsp_tpu_torch.device import to_host

__all__ = ["PREAMBLE", "same_build", "same_parse", "same_bytes_bits", "same_modulate",
           "decode_same_audio"]

PREAMBLE = 0xAB
BAUD = 520.8333333
F_MARK, F_SPACE = 2083.3333333, 1562.5


def same_build(org: str, event: str, fips, purge: str, ts: str, sender: str) -> str:
    """Compose the header string (one FIPS code string or a list)."""
    if isinstance(fips, str):
        fips = [fips]
    return f"ZCZC-{org}-{event}-{'-'.join(fips)}+{purge}-{ts}-{sender}-"


def same_parse(text: str) -> dict | None:
    """Header string -> fields, or None."""
    i = text.find("ZCZC-")
    if i < 0:
        return None
    body = text[i + 5:]
    plus = body.find("+")
    if plus < 0:
        return None
    head = body[:plus].split("-")
    tail = body[plus + 1:].split("-")
    if len(head) < 3 or len(tail) < 3:
        return None
    return {"org": head[0], "event": head[1], "fips": head[2:], "purge": tail[0],
            "timestamp": tail[1], "sender": tail[2]}


def same_bytes_bits(data: bytes, n_preamble: int = 16) -> np.ndarray:
    """Message bytes -> bit stream (LSB first, no start/stop) after the
    0xAB preamble run."""
    b = np.frombuffer(bytes([PREAMBLE] * n_preamble) + data, np.uint8)
    return ((b[:, None] >> np.arange(8)) & 1).reshape(-1).astype(np.int32)


def same_modulate(bits, fs: float = 12500.0) -> np.ndarray:
    """Bits -> real AFSK audio, continuous phase (host fixture); fs must
    give whole samples a bit (12500 -> 24)."""
    sps = fs / BAUD
    if abs(sps - round(sps)) > 1e-6:
        raise ValueError(f"fs {fs} is not an integer multiple of the 520.83 Bd bit rate")
    b = to_host(bits).astype(np.int32)
    inst = np.repeat(np.where(b == 1, F_MARK / fs, F_SPACE / fs), int(round(sps)))
    return np.cos(2 * np.pi * np.mod(np.cumsum(inst), 1.0)).astype(np.float32)


def _demod_bits(audio, fs: float, num_taps: int = 64, device=None):
    """Real audio -> hard bits on the capture's device."""
    return fsk_capture_bits(complex_audio(audio, device), 0.5 * (F_MARK + F_SPACE) / fs,
                            num_taps, 0.8 * BAUD * 2 / fs, int(round(fs / BAUD)),
                            0.5 * (F_MARK - F_SPACE) / fs)


def decode_same_audio(audio, fs: float = 12500.0, max_len: int = 268,
                      device=None) -> list[str]:
    """Real audio (a numpy array goes to `device`, None = the card) ->
    decoded header strings, one per burst: the demod on the device, then on
    the host the exact preamble bytes, the walk past the run, and ASCII
    bytes until a non-printable one or `max_len`."""
    bits = to_host(_demod_bits(audio, fs, device=device))
    if bits.size < 64:
        return []
    tp = 1.0 - 2.0 * ((PREAMBLE >> np.arange(8)) & 1).astype(np.float64)
    pm = 1.0 - 2.0 * bits.astype(np.float64)
    out = []
    used = -1
    for h in np.flatnonzero(np.correlate(pm, tp, mode="valid") >= 7.5):
        if h <= used:
            continue
        p = h
        while p + 16 <= bits.size and float(pm[p: p + 8] @ tp) >= 7.5:
            p += 8
        chars = []
        q = p
        while q + 8 <= bits.size and len(chars) < max_len:
            v = int((bits[q: q + 8] * (1 << np.arange(8))).sum())
            if not 32 <= v < 127:
                break
            chars.append(chr(v))
            q += 8
        text = "".join(chars)
        if "ZCZC-" in text or text.startswith("NNNN"):
            out.append(text)
            used = q
    return out
