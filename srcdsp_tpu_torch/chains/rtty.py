"""RTTY (Baudot/ITA2 radioteletype) and the generic async start/stop
deframer (counterpart of ``srcdsp_tpu/chains/rtty.py``).

Physical layer: 45.45 Bd FSK, 170 Hz shift, mark (logic 1, idle) the upper
tone. Characters are async serial: one start bit (space), 5 data bits LSB
first, >= 1.5 stop bits (mark); each re-synchronizes on its own start edge
(`uart_deframe`, any width and stop length). Code layer: ITA2 with LTRS
(0x1F) / FIGS (0x1B) shifts. The FSK chain runs at the half-bit rate on the
capture's device; the deframer and ITA2 are host code on one copy.
"""

from __future__ import annotations

import numpy as np

from srcdsp_tpu_torch.chains.fsk import fsk_capture_bits
from srcdsp_tpu_torch.device import as_tensor_on, to_host
from srcdsp_tpu_torch.testing.signals import fsk_baseband
from srcdsp_tpu_torch.types import CF32

__all__ = ["uart_frame", "uart_deframe", "LTRS", "FIGS", "ita2_encode", "ita2_decode",
           "rtty_modulate", "decode_rtty"]

LTRS, FIGS = 0x1F, 0x1B

# ITA2 (US-TTY), index = 5-bit code, LSB first on the wire
_ITA2_LTRS = [
    "\x00", "E", "\n", "A", " ", "S", "I", "U",
    "\r", "D", "R", "J", "N", "F", "C", "K",
    "T", "Z", "L", "W", "H", "Y", "P", "Q",
    "O", "B", "G", "<figs>", "M", "X", "V", "<ltrs>",
]
_ITA2_FIGS = [
    "\x00", "3", "\n", "-", " ", "'", "8", "7",
    "\r", "$", "4", "\x07", ",", "!", ":", "(",
    "5", '"', ")", "2", "#", "6", "0", "1",
    "9", "?", "&", "<figs>", ".", "/", ";", "<ltrs>",
]
_INV_LTRS = {c: i for i, c in enumerate(_ITA2_LTRS) if c not in ("<figs>", "<ltrs>")}
_INV_FIGS = {c: i for i, c in enumerate(_ITA2_FIGS) if c not in ("<figs>", "<ltrs>")}


def uart_frame(chars, data_bits: int = 5, stop_bits: float = 1.5, lead_idle: int = 8
               ) -> np.ndarray:
    """Character codes -> line levels (1 = mark/idle) at twice the baud rate
    (half-bit cells carry the 1.5-stop convention exactly)."""
    out = [1] * (2 * lead_idle)
    nstop = int(round(2 * stop_bits))
    for c in chars:
        out += [0, 0]
        for b in range(data_bits):
            v = (int(c) >> b) & 1
            out += [v, v]
        out += [1] * nstop
    return np.asarray(out, np.int32)


def uart_deframe(levels, data_bits: int = 5, stop_bits: float = 1.5,
                 max_chars: int = 10000) -> np.ndarray:
    """Half-bit line levels (any device) -> character codes (host sink):
    each character starts at a mark->space edge whose next half-cell is
    still space, data bits are read at their second half-cell, and the stop
    cell must be mark (else slide one half-cell and search again)."""
    lv = to_host(levels).astype(np.int32).reshape(-1)
    out = []
    i = 1
    n = lv.size
    nstop = int(round(2 * stop_bits))
    while i <= n - (2 + 2 * data_bits + 1) and len(out) < max_chars:
        if not (lv[i - 1] == 1 and lv[i] == 0) or lv[i + 1] != 0:
            i += 1
            continue
        bits = [int(lv[i + 2 + 2 * b + 1]) for b in range(data_bits)]
        if lv[i + 2 + 2 * data_bits] != 1:
            i += 1
            continue
        out.append(sum(b << k for k, b in enumerate(bits)))
        i += 2 + 2 * data_bits + nstop
    return np.asarray(out, np.int64)


def ita2_encode(text: str) -> list[int]:
    """Text -> ITA2 codes, starting in LTRS, a shift on every state change."""
    out = [LTRS]
    figs = False
    for ch in text.upper():
        if ch in _INV_LTRS and ch in _INV_FIGS and _INV_LTRS[ch] == _INV_FIGS[ch]:
            out.append(_INV_LTRS[ch])
            continue
        if ch in _INV_LTRS:
            if figs:
                out.append(LTRS)
                figs = False
            out.append(_INV_LTRS[ch])
        elif ch in _INV_FIGS:
            if not figs:
                out.append(FIGS)
                figs = True
            out.append(_INV_FIGS[ch])
        else:
            raise ValueError(f"unmapped character {ch!r}")
    return out


def ita2_decode(codes) -> str:
    out = []
    figs = False
    for c in to_host(codes).reshape(-1):
        c = int(c) & 0x1F
        if c == LTRS:
            figs = False
        elif c == FIGS:
            figs = True
        else:
            out.append((_ITA2_FIGS if figs else _ITA2_LTRS)[c])
    return "".join(out)


def rtty_modulate(levels, sps_half: int, dev: float) -> np.ndarray:
    """Half-bit levels -> complex FSK baseband (host fixture), mark = +dev;
    sps_half samples a half bit (baud = fs / (2 sps_half))."""
    return fsk_baseband(to_host(levels).astype(np.float32), sps_half, dev)


def decode_rtty(x, sps_half: int, dev: float, num_taps: int = 64, device=None) -> str:
    """Complex baseband (a numpy array goes to `device`, None = the card) ->
    text: the FSK chain at the half-bit rate on the capture's device, then
    the async deframe and ITA2 on the host."""
    lv = fsk_capture_bits(as_tensor_on(x, device, CF32), 0.0, num_taps, 1.6 * dev, sps_half, dev)
    return ita2_decode(uart_deframe(lv))
