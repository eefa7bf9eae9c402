"""AX.25 / APRS over Bell-202 AFSK (counterpart of ``srcdsp_tpu/chains/ax25.py``).

The link layer is the AIS one (`chains.ais`): HDLC flags, bit stuffing, the
X-25 FCS and NRZI; AX.25 idles on repeated flags. New here: the address
layer (callsigns ASCII<<1 + SSID byte with the extension bit, UI frames,
control 0x03, PID 0xF0) and the Bell-202 physical layer (mark 1200 Hz, space
2200 Hz at 1200 bd). The receiver complexifies the audio and runs the FSK
chain centred between the tones on the capture's device; the frame search
is the AIS host sink, which copies the levels to the host once.
"""

from __future__ import annotations

import numpy as np

from srcdsp_tpu_torch.chains.ais import build_hdlc_air_bits, decode_all_ais_frames, nrzi_encode
from srcdsp_tpu_torch.chains.fsk import complex_audio, fsk_capture_bits
from srcdsp_tpu_torch.device import to_host
from srcdsp_tpu_torch.hdlc import FLAG

__all__ = ["encode_address", "decode_address", "build_ax25_frame", "parse_ax25",
           "afsk_modulate", "decode_ax25_audio", "build_aprs_frame"]

_CTRL_UI = 0x03
_PID_NONE = 0xF0


def encode_address(call: str, ssid: int = 0, last: bool = False,
                   command: bool = False) -> bytes:
    """Callsign (<= 6 chars) + SSID -> the 7-byte address field; byte 7 is
    0b011_SSID_E with E the extension bit (1 only on the last address)."""
    call = call.upper().ljust(6)[:6]
    b = bytes((ord(c) << 1) & 0xFF for c in call)
    ss = 0x60 | ((ssid & 0xF) << 1) | (1 if last else 0)
    if command:
        ss |= 0x80
    return b + bytes([ss])


def decode_address(b: bytes) -> tuple[str, int, bool]:
    """7 bytes -> (callsign, ssid, last)."""
    call = "".join(chr(v >> 1) for v in b[:6]).rstrip()
    return call, (b[6] >> 1) & 0xF, bool(b[6] & 1)


def build_ax25_frame(dest: str, src: str, info: bytes, path: tuple = (),
                     dest_ssid: int = 0, src_ssid: int = 0,
                     n_preamble_flags: int = 8) -> np.ndarray:
    """UI frame -> NRZI line levels for `afsk_modulate`; `path` holds
    digipeater (callsign, ssid) pairs; the preamble is repeated flags."""
    addrs = [encode_address(dest, dest_ssid, command=True),
             encode_address(src, src_ssid, last=not path)]
    for i, (c, s) in enumerate(path):
        addrs.append(encode_address(c, s, last=(i == len(path) - 1)))
    payload = b"".join(addrs) + bytes([_CTRL_UI, _PID_NONE]) + bytes(info)
    pre = np.tile(FLAG, n_preamble_flags).astype(np.int32)
    return nrzi_encode(np.concatenate([pre, build_hdlc_air_bits(payload)]))


def parse_ax25(payload: bytes) -> dict | None:
    """FCS-clean frame bytes -> {dest, src, path, control, pid, info}, or
    None when the address chain is malformed."""
    if len(payload) < 16:
        return None
    dest = decode_address(payload[0:7])
    src = decode_address(payload[7:14])
    path = []
    off = 14
    last = src[2]
    while not last:
        if off + 7 > len(payload) or len(path) >= 8:
            return None
        a = decode_address(payload[off: off + 7])
        path.append((a[0], a[1]))
        last = a[2]
        off += 7
    if off + 2 > len(payload):
        return None
    return {"dest": (dest[0], dest[1]), "src": (src[0], src[1]), "path": tuple(path),
            "control": payload[off], "pid": payload[off + 1], "info": payload[off + 2:]}


def build_aprs_frame(src: str, text: str, dest: str = "APRS",
                     path: tuple = (("WIDE1", 1),)) -> np.ndarray:
    """APRS convenience: a UI text frame via the standard path."""
    return build_ax25_frame(dest, src, text.encode(), path=path)


def afsk_modulate(levels, sps: int, f_mark: float, f_space: float) -> np.ndarray:
    """NRZI line levels -> real Bell-202 audio, continuous phase (host
    fixture). f_mark/f_space in cycles/sample; level 1 -> mark."""
    lv = to_host(levels).astype(np.int32)
    inst = np.repeat(np.where(lv == 1, f_mark, f_space), sps)
    return np.cos(2 * np.pi * np.cumsum(inst)).astype(np.float32)


def decode_ax25_audio(audio, sps: int, f_mark: float, f_space: float,
                      num_taps: int = 64, device=None) -> list[dict]:
    """Real audio -> parsed AX.25 frames: the FSK chain centred between the
    tones on the capture's device, then the AIS HDLC stream decode, FCS gate
    and address parse on the host."""
    fc = 0.5 * (f_mark + f_space)
    dev = 0.5 * (f_space - f_mark)
    lv_hat = fsk_capture_bits(complex_audio(audio, device), fc, num_taps, 1.6 * dev, sps, dev)
    out = []
    for payload, start in decode_all_ais_frames(lv_hat):
        rec = parse_ax25(payload)
        if rec is not None:
            rec["start_bit"] = int(start)
            out.append(rec)
    return out
