"""CW (Morse) keying (counterpart of ``srcdsp_tpu/chains/cw.py``): an on-off
keyed carrier decoded blind (tone from the spectrum peak, speed from the
on-run statistics: the dit is the mean of the short cluster of a 2-means
split; elements split at 2 dits, gaps at 2 and 5 dits). The reference's
receiver is host numpy (FFT, `np.convolve`, percentiles, run lengths); so is
the port's, on one copy of the audio from any device. Table: the ITU
alphabet, digits and common punctuation.
"""

from __future__ import annotations

import numpy as np

from srcdsp_tpu_torch.device import to_host
from srcdsp_tpu_torch.ops.window import lowpass

__all__ = ["MORSE", "morse_encode_timing", "cw_modulate", "decode_cw"]

MORSE = {
    "A": ".-", "B": "-...", "C": "-.-.", "D": "-..", "E": ".",
    "F": "..-.", "G": "--.", "H": "....", "I": "..", "J": ".---",
    "K": "-.-", "L": ".-..", "M": "--", "N": "-.", "O": "---",
    "P": ".--.", "Q": "--.-", "R": ".-.", "S": "...", "T": "-",
    "U": "..-", "V": "...-", "W": ".--", "X": "-..-", "Y": "-.--",
    "Z": "--..",
    "0": "-----", "1": ".----", "2": "..---", "3": "...--",
    "4": "....-", "5": ".....", "6": "-....", "7": "--...",
    "8": "---..", "9": "----.",
    ".": ".-.-.-", ",": "--..--", "?": "..--..", "/": "-..-.",
    "=": "-...-", "+": ".-.-.", "-": "-....-", "@": ".--.-.",
}
_INV = {v: k for k, v in MORSE.items()}


def morse_encode_timing(text: str) -> list[tuple[int, int]]:
    """Text -> [(on, dits)] runs: dit 1, dah 3, element gap 1, character
    gap 3, word gap 7."""
    runs = []
    for word in text.upper().split():
        if runs:
            runs.append((0, 7))
        first_ch = True
        for ch in word:
            code = MORSE.get(ch)
            if code is None:
                raise ValueError(f"no morse for {ch!r}")
            if not first_ch:
                runs.append((0, 3))
            first_ch = False
            for i, el in enumerate(code):
                if i:
                    runs.append((0, 1))
                runs.append((1, 1 if el == "." else 3))
    return runs


def cw_modulate(text: str, wpm: float, fs: float, tone_hz: float,
                rise_ms: float = 3.0) -> np.ndarray:
    """Text -> real keyed audio (host fixture): dit 1.2 / wpm seconds (PARIS),
    the keying envelope smoothed by a short Hann window."""
    dit_s = 1.2 / wpm
    env = [np.full(int(round(dits * dit_s * fs)), 1.0 if on else 0.0, np.float64)
           for on, dits in morse_encode_timing(text)]
    env = np.concatenate(env) if env else np.zeros(0)
    nr = max(2, int(rise_ms * 1e-3 * fs))
    w = np.hanning(2 * nr + 1)
    sh = np.convolve(env, w / w.sum(), "same")
    return (sh * np.cos(2 * np.pi * tone_hz / fs * np.arange(env.size))).astype(np.float32)


def _runs(mask: np.ndarray):
    """Boolean mask -> [(value, length)] run-length encoding."""
    if mask.size == 0:
        return []
    change = np.flatnonzero(np.diff(mask.astype(np.int8))) + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [mask.size]])
    return [(bool(mask[s]), int(e - s)) for s, e in zip(starts, ends)]


def decode_cw(audio, fs: float) -> dict:
    """Real audio or complex baseband (any device) -> {'text', 'wpm',
    'tone_hz'} (host sink)."""
    x = to_host(audio)
    n = x.size
    if np.iscomplexobj(x):
        tone = float(np.fft.fftfreq(n, 1.0 / fs)[int(np.argmax(np.abs(np.fft.fft(x))))])
    else:
        spec = np.abs(np.fft.rfft(x))
        spec[0] = 0.0
        tone = float(np.argmax(spec)) * fs / (2 * (spec.size - 1))
    ph = 2 * np.pi * np.mod(tone / fs * np.arange(n, dtype=np.float64), 1.0)
    z = x.astype(np.complex128) * np.exp(-1j * ph)
    h = np.asarray(lowpass(101, min(0.4, 120.0 / fs)), np.float64)
    env = np.abs(np.convolve(z, h, "same"))
    hi = np.percentile(env, 95)
    if hi <= 0:
        return {"text": "", "wpm": 0.0, "tone_hz": tone}
    runs = _runs(env > 0.5 * hi)
    if runs and not runs[0][0]:
        runs = runs[1:]
    if runs and not runs[-1][0]:
        runs = runs[:-1]
    on_lens = np.asarray([l for v, l in runs if v], np.float64)
    if on_lens.size < 2:
        return {"text": "", "wpm": 0.0, "tone_hz": tone}
    thr = 2.0 * on_lens.min()
    for _ in range(8):
        short = on_lens[on_lens < thr]
        long_ = on_lens[on_lens >= thr]
        m0 = short.mean() if short.size else on_lens.min()
        m1 = long_.mean() if long_.size else 3 * m0
        new = 0.5 * (m0 + m1)
        if abs(new - thr) < 0.5:
            break
        thr = new
    dit = float(short.mean()) if short.size else float(on_lens.min())
    text = []
    sym = []
    for v, l in runs:
        if v:
            sym.append("." if l < 2.0 * dit else "-")
        elif l >= 2.0 * dit:
            text.append(_INV.get("".join(sym), "*"))
            sym = []
            if l >= 5.0 * dit:
                text.append(" ")
    if sym:
        text.append(_INV.get("".join(sym), "*"))
    return {"text": "".join(text), "wpm": float(1.2 / (dit / fs)), "tone_hz": float(tone)}
