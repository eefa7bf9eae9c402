"""NAVTEX / SITOR-B (FEC broadcast telex) (counterpart of
``srcdsp_tpu/chains/navtex.py``).

Physical layer: 100 Bd FSK, 170 Hz shift (mark/space +-85 Hz at complex
baseband), demodulated by the FSK chain on the capture's device. Code layer:
CCIR 476 style 7-bit constant-weight codes (4 marks, 3 spaces); the
character-to-codeword table is the reference's repo convention (the weight-4
codes in ascending order over a fixed roster). FEC layer: time diversity,
DX(n) interleaved with RX(n-5); the receiver takes whichever copy passes the
weight check, '*' where both fail; the rep/alpha phasing finds the character
boundary and the lane parity. Message layer: 'ZCZC B1B2B3B4' ... 'NNNN'.
The framing and the codec are host code on one copy of the bits.
"""

from __future__ import annotations

import numpy as np

from srcdsp_tpu_torch.chains.fsk import fsk_capture_bits
from srcdsp_tpu_torch.device import as_tensor_on, to_host
from srcdsp_tpu_torch.testing.signals import fsk_baseband
from srcdsp_tpu_torch.types import CF32

__all__ = ["CW_TABLE", "code_to_char", "ALPHA", "REP", "LTRS", "FIGS", "sitor_b_encode",
           "sitor_b_decode", "navtex_build", "navtex_parse", "navtex_modulate",
           "decode_navtex_audio"]


def _weight4_codes() -> list[int]:
    return [c for c in range(128) if bin(c).count("1") == 4]   # 35


_TABLE_ROSTER = (["<alpha>", "<rep>", "<ltrs>", "<figs>", " ", "\r", "\n"]
                 + list("ABCDEFGHIJKLMNOPQRSTUVWXYZ") + ["?", "/"])

CW_TABLE = dict(zip(_TABLE_ROSTER, _weight4_codes()))
_INV = {v: k for k, v in CW_TABLE.items()}
ALPHA, REP = CW_TABLE["<alpha>"], CW_TABLE["<rep>"]
LTRS, FIGS = CW_TABLE["<ltrs>"], CW_TABLE["<figs>"]

# the digits ride the letter codewords of the top row under the FIGS shift
_FIGS_MAP = dict(zip("QWERTYUIOP", "1234567890"))
_FIGS_INV = {v: k for k, v in _FIGS_MAP.items()}


def code_to_char(code: int, figs: bool) -> str:
    ch = _INV.get(code)
    if ch is None:
        return "*"
    if figs and ch in _FIGS_MAP:
        return _FIGS_MAP[ch]
    return ch


def _text_codes(text: str) -> list[int]:
    """Text -> codewords with LTRS/FIGS shifts inserted (only the digit row
    is shift-sensitive)."""
    out = []
    figs = False
    for ch in text.upper():
        if ch in _FIGS_INV:
            if not figs:
                out.append(FIGS)
                figs = True
            out.append(CW_TABLE[_FIGS_INV[ch]])
        elif ch in CW_TABLE:
            if figs and ch in _FIGS_MAP:
                out.append(LTRS)
                figs = False
            out.append(CW_TABLE[ch])
        else:
            raise ValueError(f"unmapped character {ch!r}")
    return out


def sitor_b_encode(codes, n_phasing: int = 14) -> np.ndarray:
    """Codewords -> the diversity stream: slot 2k carries DX(k), slot 2k+1
    RX(k-5) (alpha / rep fill), after the alpha/rep phasing sequence."""
    codes = list(codes)
    n = len(codes)
    tx = []
    for k in range(n + 5):
        tx.append(codes[k] if k < n else ALPHA)
        tx.append(codes[k - 5] if 0 <= k - 5 < n else REP)
    return np.asarray([ALPHA, REP] * n_phasing + tx, np.int64)


def sitor_b_decode(stream) -> tuple[str, int]:
    """Received codeword stream (any alignment, any device) -> (text,
    erasures): the lane parity from where REP lives, then per character DX
    if weight 4, else RX, else '*' (none in the phasing head)."""
    s = to_host(stream).astype(np.int64).reshape(-1)
    dx_off = 1 if int((s[0::2] == REP).sum()) > int((s[1::2] == REP).sum()) else 0
    dx = s[dx_off::2]
    rx = s[1 - dx_off::2]
    lag = 5 + dx_off
    out = []
    erase = 0
    figs = False
    started = False
    for k in range(dx.size):
        c_dx = int(dx[k])
        c_rx = int(rx[k + lag]) if k + lag < rx.size else -1
        if bin(c_dx).count("1") == 4:
            c = c_dx
        elif c_rx >= 0 and bin(c_rx).count("1") == 4:
            c = c_rx
        else:
            if started:
                out.append("*")
                erase += 1
            continue
        if c == LTRS:
            figs = False
            continue
        if c == FIGS:
            figs = True
            continue
        if c in (ALPHA, REP):
            continue
        started = True
        out.append(code_to_char(c, figs))
    return "".join(out), erase


def navtex_build(station: str, msg_type: str, serial: str, body: str) -> str:
    """Compose a NAVTEX message: ZCZC B1B2B3B4 <body> NNNN."""
    if len(station) != 1 or len(msg_type) != 1 or len(serial) != 2:
        raise ValueError("station/type = 1 char each, serial = 2 digits")
    return f"ZCZC {station}{msg_type}{serial}\r\n{body}\r\nNNNN"


def navtex_parse(text: str) -> dict | None:
    """Decoded text -> {'station', 'type', 'serial', 'body'} or None."""
    i = text.find("ZCZC ")
    j = text.find("NNNN", i + 5) if i >= 0 else -1
    if i < 0 or j < 0 or j <= i + 9:
        return None
    head = text[i + 5: i + 9]
    return {"station": head[0], "type": head[1], "serial": head[2:4],
            "body": text[i + 9: j].strip("\r\n *")}


def navtex_modulate(codes, sps: int, dev: float) -> np.ndarray:
    """Codeword stream -> complex FSK baseband (host fixture): 7 bits a
    char LSB first, mark (1) = +dev, space = -dev cycles/sample."""
    codes = to_host(codes).astype(np.int64)
    bits = ((codes[:, None] >> np.arange(7)) & 1).reshape(-1)
    return fsk_baseband(bits, sps, dev)


def decode_navtex_audio(x, sps: int, dev: float, num_taps: int = 64,
                        device=None) -> tuple[str, int]:
    """Complex baseband (a numpy array goes to `device`, None = the card) ->
    (text, erasures): the FSK chain at centre 0 on the capture's device, then
    on the host the 7-bit framing from the phasing pattern (period 14 bits,
    correlated over the stream head) and the SITOR-B decode."""
    bits = to_host(fsk_capture_bits(as_tensor_on(x, device, CF32), 0.0, num_taps, 1.6 * dev,
                                    sps, dev))
    pat = ((np.asarray([ALPHA, REP], np.int64)[:, None] >> np.arange(7)) & 1).reshape(-1)
    pm = 1.0 - 2.0 * bits[: min(bits.size, 14 * 40)].astype(np.float64)
    tp = 1.0 - 2.0 * pat.astype(np.float64)
    best, best_off = None, 0
    for off in range(14):
        seg = pm[off:]
        nrep = seg.size // 14
        if nrep < 3:
            break
        sc = float(seg[: nrep * 14].reshape(nrep, 14).sum(0) @ tp)
        if best is None or sc > best:
            best, best_off = sc, off
    bits = bits[best_off:]
    nch = bits.size // 7
    codes = (bits[: nch * 7].reshape(nch, 7) @ (1 << np.arange(7))).astype(np.int64)
    return sitor_b_decode(codes)
