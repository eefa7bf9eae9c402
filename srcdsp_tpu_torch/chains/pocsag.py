"""POCSAG pager protocol (counterpart of ``srcdsp_tpu/chains/pocsag.py``):
2-FSK NRZ carrying 32-bit codewords of BCH(31,21) t = 2 (``bch``) plus an
even parity bit. A transmission is >= 576 bits of 1010 preamble, then
batches of [FSC | 8 frames x 2 codewords]; FSC 0x7CD215D8 and the idle word
0x7A89C197 are valid codewords. Address codewords (flag 0) carry the RIC's
high 18 bits and 2 function bits, the low 3 RIC bits implicit in the frame;
message codewords (flag 1) carry 20 data bits (BCD nibbles or 7-bit ASCII).

The BCH code is built lazily, on the CPU (`make_bch_code` resolves a device,
so a module-level copy would need a card at import). The codec runs
on the host: `decode_transmission` copies the bits once and corrects each
batch's 16 words in one batched decode on CPU tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from srcdsp_tpu_torch.bch import BchCode, bch_decode, bch_encode, make_bch_code
from srcdsp_tpu_torch.device import to_host
from srcdsp_tpu_torch.testing.signals import fsk_baseband

__all__ = ["FSC", "IDLE", "make_codeword", "address_codeword", "message_codeword",
           "encode_transmission", "decode_transmission", "encode_numeric", "decode_numeric",
           "encode_alpha", "decode_alpha", "pocsag_baseband"]

FSC = 0x7CD215D8
IDLE = 0x7A89C197

_BCD = "0123456789*U -)("            # POCSAG numeric character set


@functools.lru_cache(maxsize=None)
def _code() -> BchCode:
    """BCH(31, 21) t = 2, generator 0x769, on the CPU, built on first use."""
    return make_bch_code(5, 2, device="cpu")


def _int_to_bits(v: int, width: int) -> np.ndarray:
    return np.asarray([(v >> (width - 1 - i)) & 1 for i in range(width)], np.int32)


def _bits_to_int(bits) -> int:
    v = 0
    for b in np.asarray(bits, int):
        v = (v << 1) | int(b)
    return v


def make_codeword(info21) -> np.ndarray:
    """21 info bits -> 32-bit codeword (BCH parity + even parity)."""
    info = torch.as_tensor(to_host(info21).astype(np.int32)[None])
    cw31 = bch_encode(_code(), info)[0].numpy()
    return np.concatenate([cw31, [int(cw31.sum()) % 2]]).astype(np.int32)


def address_codeword(ric: int, func: int = 0) -> np.ndarray:
    """RIC (21 bits) + 2-bit function -> 32 bits; the low 3 RIC bits pick
    the frame (ric & 7) and are not sent."""
    return make_codeword(np.concatenate([[0], _int_to_bits(ric >> 3, 18), _int_to_bits(func, 2)]))


def message_codeword(data20: int) -> np.ndarray:
    return make_codeword(np.concatenate([[1], _int_to_bits(data20, 20)]))


def encode_numeric(digits: str) -> list[int]:
    """Numeric message -> 20-bit data words (5 BCD nibbles a word, padded
    with spaces)."""
    nibs = [_BCD.index(ch) for ch in digits]
    while len(nibs) % 5:
        nibs.append(_BCD.index(" "))
    return [_bits_to_int(np.concatenate([_int_to_bits(nb, 4) for nb in nibs[i: i + 5]]))
            for i in range(0, len(nibs), 5)]


def decode_numeric(words: list[int]) -> str:
    return "".join(_BCD[(w >> (16 - 4 * j)) & 0xF] for w in words for j in range(5)).rstrip()


def encode_transmission(pages, preamble_bits: int = 576) -> np.ndarray:
    """pages: [(ric, func, [data20, ...])] -> air bits. Each page's address
    goes in frame ric & 7, its message words in the slots after it; unused
    slots carry IDLE."""
    batches = []
    slots: list[np.ndarray] = []

    def flush():
        nonlocal slots
        while len(slots) % 16:
            slots.append(_int_to_bits(IDLE, 32))
        for i in range(0, len(slots), 16):
            batches.append(np.concatenate([_int_to_bits(FSC, 32)] + slots[i: i + 16]))
        slots = []

    for ric, func, datas in pages:
        pad = (2 * (ric & 7) - len(slots) % 16) % 16
        slots.extend(_int_to_bits(IDLE, 32) for _ in range(pad))
        slots.append(address_codeword(ric, func))
        slots.extend(message_codeword(d) for d in datas)
    flush()
    pre = np.tile([1, 0], preamble_bits // 2).astype(np.int32)
    return np.concatenate([pre] + batches).astype(np.int32)


def _correct_words(words: np.ndarray) -> list[tuple[np.ndarray | None, int]]:
    """Words [K, 32] -> [(info21 | None, corrected count)]. BCH corrects <= 2
    errors in the first 31 bits; a parity mismatch on a word that already
    took t corrections means >= t + 1 errors (rejected), on a cleaner word it
    is the parity bit's own error (accepted, counted)."""
    code = _code()
    recv = torch.as_tensor(words[:, :31].astype(np.int32))
    msg, ok = bch_decode(code, recv)
    cw31 = bch_encode(code, msg).numpy()
    msg, ok = msg.numpy(), ok.numpy()
    nerr = (cw31 != words[:, :31]).sum(axis=1)
    par_ok = (cw31.sum(axis=1) + words[:, 31]) % 2 == 0
    out = []
    for k in range(words.shape[0]):
        if not ok[k] or (not par_ok[k] and nerr[k] >= code.t):
            out.append((None, 0))
        else:
            out.append((msg[k], int(nerr[k]) + (0 if par_ok[k] else 1)))
    return out


def decode_transmission(bits, max_sync_err: int = 2):
    """Air bits (any device) -> pages [{ric, func, data: [int], corrected}]
    (host sink). FSC by Hamming distance (<= max_sync_err flips), then
    17-word batches, every word BCH-corrected."""
    bits = to_host(bits).astype(np.int32).reshape(-1)
    fsc = _int_to_bits(FSC, 32)
    if bits.size < 32 * 17:
        return []
    dist = (np.lib.stride_tricks.sliding_window_view(bits, 32) != fsc).sum(axis=1)
    for start in np.flatnonzero(dist <= max_sync_err):
        pages = _walk_batches(bits, int(start), fsc, max_sync_err)
        if pages:
            return pages
    return []


def _walk_batches(bits: np.ndarray, p: int, fsc: np.ndarray, max_sync_err: int):
    pages = []
    cur = None
    while p + 32 * 17 <= bits.size:
        if (bits[p: p + 32] != fsc).sum() > max_sync_err:
            break
        fixed = _correct_words(bits[p + 32: p + 32 * 17].reshape(16, 32))
        for slot, (info, nerr) in enumerate(fixed):
            if info is None:
                continue
            if _bits_to_int(info) == (IDLE >> 11):
                continue
            if info[0] == 0:
                cur = {"ric": (_bits_to_int(info[1:19]) << 3) | (slot // 2),
                       "func": _bits_to_int(info[19:21]), "data": [], "corrected": nerr}
                pages.append(cur)
            elif cur is not None:
                cur["data"].append(_bits_to_int(info[1:21]))
                cur["corrected"] += nerr
        p += 32 * 17
    return pages


def pocsag_baseband(bits, sps: int, dev: float = 0.1) -> np.ndarray:
    """Air bits -> complex 2-FSK baseband (host fixture; the bit value
    selects the tone)."""
    return fsk_baseband(to_host(bits).astype(np.int32), sps, dev)


def encode_alpha(text: str) -> list[int]:
    """Alphanumeric message -> 20-bit data words: 7-bit ASCII LSB-first,
    packed across the words; the last word padded with EOT (0x04)."""
    bits: list[int] = []
    for c in text:
        bits.extend((ord(c) & 0x7F) >> i & 1 for i in range(7))
    target = -(-len(bits) // 20) * 20
    while len(bits) < target:
        bits.extend(0x04 >> i & 1 for i in range(7))
    bits = bits[:target]
    return [_bits_to_int(bits[i: i + 20]) for i in range(0, len(bits), 20)]


def decode_alpha(words: list[int]) -> str:
    """Inverse of encode_alpha; stops at the first EOT/NUL."""
    bits: list[int] = []
    for w in words:
        bits.extend(_int_to_bits(w, 20).tolist())
    out = []
    for i in range(0, len(bits) - 6, 7):
        c = sum(bits[i + j] << j for j in range(7))
        if c in (0x00, 0x04):
            break
        out.append(chr(c))
    return "".join(out)
