"""Chirp spread spectrum (CSS, LoRa-class) modem (counterpart of
``srcdsp_tpu/chains/css.py``): cyclic-shift chirp modulation, dechirp-FFT
demodulation, preamble sync, and a coded frame layer (Gray mapping + nibble
Hamming FEC + diagonal interleaver + whitening + CRC-16).

Discrete-time model (critically sampled, 1 sample/chip, N = 2^SF chips per
symbol): the base upchirp is u[n] = exp(j*pi*n^2/N); data symbol k in [0, N)
is the cyclic shift x_k[n] = u[(n+k) mod N] = exp(j*pi*(n+k)^2/N), and
dechirping with conj(u) leaves a tone at DFT bin k, so the demodulator is
dechirp -> N-point DFT -> argmax. Phases come from exact integer arithmetic
(pi * ((m*m) mod 2N) / N).

Where each part runs:

- the parameters keep their chirps as host numpy (`CssParams`), as the
  reference does; the device stages take them to the stream's device;
- the transmit side and the frame codec (Gray, Hamming, interleaver,
  whitening, CRC-16, `css_encode_frame`, the per-frame decoders) are host
  numpy, the port's own copy; the CRC-16 runs the port's gf2 CRC engine on
  the CPU, as the reference runs its own;
- the device stages are torch on the input's device: `css_frames`,
  `css_demod`, `css_demod_frames`, the dechirp FFTs and the candidate
  scores of `css_sync`, `css_derotate` and `css_soft_llrs`; the sync's run
  search and CFO solve stay host logic over the copied-back bins, as in the
  reference;
- `css_decode_frames_soft_batch` runs on the LLRs' device: the deinterleave
  is one index take, the ML nibble correlation one float64 product with the
  16 codewords, the CRC-16 one float64 GF(2) product; the payload bytes are
  packed on the host after one copy of the bits back.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from srcdsp_tpu_torch.device import as_tensor_on
from srcdsp_tpu_torch.gf2 import crc_init, crc_update, crc_value, make_crc
from srcdsp_tpu_torch.types import CF32, F32

__all__ = [
    "CssParams", "make_css_params", "base_upchirp", "chirp_symbol",
    "css_modulate", "css_frames", "css_demod", "css_demod_frames",
    "CssSync", "css_preamble", "preamble_len", "css_sync", "css_derotate",
    "hamming_encode_nibbles", "hamming_decode_nibbles",
    "bits_to_nibbles", "gray_encode_shift", "gray_decode_shift",
    "diag_interleave", "diag_deinterleave", "whitening_seq", "crc16_ccitt",
    "css_encode_frame", "css_decode_frame", "css_frame_nsym",
    "css_soft_llrs", "css_decode_frame_soft", "css_decode_frames_soft_batch",
    "css_transmit", "css_receive", "css_receive_stream",
]


# ---------------------------------------------------------------------------
# chirp synthesis (exact integer phase)
# ---------------------------------------------------------------------------

def _chirp_phase_frac(m: np.ndarray, n: int) -> np.ndarray:
    """phase/(2*pi) of exp(j*pi*m^2/N) as the exact fraction ((m*m) mod 2N) / 2N."""
    r = (m.astype(np.int64) * m.astype(np.int64)) % (2 * n)
    return r.astype(np.float64) / (2.0 * n)


def base_upchirp(n: int) -> np.ndarray:
    """u[n] = exp(j*pi*n^2/N), complex64 [N]. Host-side constant."""
    fr = _chirp_phase_frac(np.arange(n), n)
    return np.exp(2j * np.pi * fr).astype(np.complex64)


def chirp_symbol(n: int, k: int) -> np.ndarray:
    """x_k[n] = u[(n+k) mod N] = exp(j*pi*(n+k)^2/N), complex64 [N]."""
    fr = _chirp_phase_frac(np.arange(n) + int(k), n)
    return np.exp(2j * np.pi * fr).astype(np.complex64)


class CssParams(NamedTuple):
    sf: int                 # spreading factor: SF bits / symbol
    n: int                  # 2^SF chips per symbol (1 sample/chip)
    cr: int                 # parity bits per nibble codeword (1..4)
    n_up: int               # preamble upchirps
    sync1: int              # sync-word shifts (two known non-zero
    sync2: int              # symbols marking the preamble end)
    upchirp: np.ndarray     # [N] c64 base upchirp u (host numpy)
    downchirp: np.ndarray   # [N] c64 conj(u) (host numpy)


def make_css_params(sf: int = 8, cr: int = 4, n_up: int = 8,
                    sync1: int | None = None, sync2: int | None = None) -> CssParams:
    """CSS parameters. sf in [5, 12]; cr parity bits in [1, 4] (cr >= 3
    corrects single bit errors per nibble, cr <= 2 detects only). Sync shifts
    default to N/8 and 3N/8."""
    if not 5 <= sf <= 12:
        raise ValueError(f"sf must be in [5, 12], got {sf}")
    if not 1 <= cr <= 4:
        raise ValueError(f"cr must be in [1, 4], got {cr}")
    n = 1 << sf
    u = base_upchirp(n)
    return CssParams(sf=sf, n=n, cr=cr, n_up=n_up,
                     sync1=n // 8 if sync1 is None else int(sync1),
                     sync2=3 * n // 8 if sync2 is None else int(sync2),
                     upchirp=u, downchirp=np.conj(u))


def _chirp(c: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(c, dtype=CF32, device=device)


# ---------------------------------------------------------------------------
# modulation / demodulation
# ---------------------------------------------------------------------------

def css_modulate(params: CssParams, shifts: np.ndarray) -> np.ndarray:
    """Symbol shifts [S] in [0, N) -> waveform [S*N] complex64 (host numpy,
    exact integer phase per symbol and chip)."""
    shifts = np.asarray(shifts, np.int64)
    n = params.n
    m = np.arange(n)[None, :] + shifts[:, None]          # [S, N]
    fr = _chirp_phase_frac(m, n)
    return np.exp(2j * np.pi * fr).astype(np.complex64).reshape(-1)


def css_frames(params: CssParams, x: torch.Tensor) -> torch.Tensor:
    """Chip stream [S*N] -> dechirped symbol frames [S, N] (symbol k becomes
    a tone at bin k)."""
    n = params.n
    s = x.shape[-1] // n
    return x[: s * n].reshape(s, n) * _chirp(params.downchirp, x.device)


def css_demod(params: CssParams, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Demodulate an aligned chip stream [S*N] -> (shifts [S] int32, peak [S]
    complex64, the complex DFT peak)."""
    return css_demod_frames(params, css_frames(params, x))


def css_demod_frames(params: CssParams, frames: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Demodulate pre-dechirped frames [S, N] (css_frames output). The
    decision is the first maximum of |spectrum|, as jnp.argmax takes it."""
    spec = torch.fft.fft(frames, dim=-1)
    k = torch.argmax(torch.abs(spec), dim=-1)
    return k.to(torch.int32), torch.gather(spec, -1, k[:, None])[:, 0]


# ---------------------------------------------------------------------------
# preamble sync
# ---------------------------------------------------------------------------

def _wrap_half(v, n: int):
    """Wrap bin/chip values into [-N/2, N/2)."""
    return (np.asarray(v) + n // 2) % n - n // 2


class CssSync(NamedTuple):
    start: int              # chip index of the first payload sample
    cfo_bins: float         # carrier offset in bins (int + fractional)
    tau: int                # residual integer chip timing (diagnostics)
    ok: bool


def css_preamble(params: CssParams) -> np.ndarray:
    """Transmit preamble: n_up upchirps, the 2-symbol sync word, then 2
    downchirps. [(n_up+4) * N] complex64."""
    ups = css_modulate(params, [0] * params.n_up + [params.sync1, params.sync2])
    downs = np.conj(css_modulate(params, [0, 0]))
    return np.concatenate([ups, downs])


def preamble_len(params: CssParams) -> int:
    return (params.n_up + 4) * params.n


def css_sync(params: CssParams, x, device=None) -> CssSync:
    """Locate the preamble and estimate CFO; returns the payload start.

    The dechirp FFTs run on x's device (a non-tensor x goes to `device`, None
    = the card); the run search over the argmax bins, the sync-word check and
    the up/down-chirp solve run on the host over the copied-back bins and
    peaks, as in the reference: a run of >= 3 (nearly) equal upchirp bins
    b_up = (eps - tau) mod N validated by the sync word, the fractional CFO
    from the peak phase advance, and the downchirp bin b_dn = (eps + tau)
    mod N from the stronger of two grid frames.

    The solve has two wraps where the reference commits to one branch and
    can be wrong: 2*eps is known mod N (the half-N branch, which moves tau
    by N/2), and a fractional CFO near +-0.5 leaves the integer bin, and
    with it tau, one off either way; a preamble near N/2 off the frame grid
    also lets the sync-word search pick the frame one symbol off, or miss
    sync1 (then the run's last frame stands for it, where the reference
    goes on to a later burst's preamble). The peaks' phases lose the
    fraction when the argmax flips between two bins, so it is also read at
    fixed bins. So the reference's answer is held against the neighbouring
    candidates (`_sync_candidates`), each scored on the capture by the
    energy of the sync word and the two downchirps at their expected bins
    (`_sync_scores`). The reference's answer stands unless its sync-word
    energy is below half the best candidate's (then the data symbols, which
    see the same eps - tau, would come out off); the best total energy
    replaces it.
    """
    n, nup = params.n, params.n_up
    xx = as_tensor_on(x, device, CF32)
    nsym = int(xx.shape[-1]) // n
    if nsym < nup + 4:
        return CssSync(0, 0.0, 0, False)
    frames = xx[: nsym * n].reshape(nsym, n)
    up_spec = torch.fft.fft(frames * _chirp(params.downchirp, xx.device), dim=-1)
    up_idx = torch.argmax(torch.abs(up_spec), dim=-1)
    up_pk = torch.gather(up_spec, -1, up_idx[:, None])[:, 0].cpu().numpy()
    up_bin = up_idx.cpu().numpy()

    runs = []
    i = 0
    while i < nsym:
        j = i
        while (j + 1 < nsym
               and abs(int(_wrap_half(int(up_bin[j + 1]) - int(up_bin[i]), n))) <= 1):
            j += 1
        if j - i + 1 >= 3:
            runs.append((i, j - i + 1))
        i = j + 1

    best_i = best_len = None
    sync_end = None
    for ri, rl in runs:
        b_up_c = int(up_bin[ri + rl // 2])
        for f in range(ri + rl - 1, min(ri + rl + 3, nsym - 1)):
            d1 = int(_wrap_half(int(up_bin[f]) - b_up_c - params.sync1, n))
            d2 = int(_wrap_half(int(up_bin[f + 1]) - b_up_c - params.sync2, n))
            if abs(d1) <= 1 and abs(d2) <= 1:
                sync_end = f + 2      # first downchirp frame index
                break
        if sync_end is None:
            # a preamble near N/2 off the grid can hide sync1: the frame that
            # straddles (up | sync1) shows the upchirp and the one that
            # straddles (sync1 | sync2) shows sync2. Then sync1 is taken at the
            # run's last frame; the candidates below try the grid index
            # either way.
            f = ri + rl - 1
            if f + 2 < nsym and all(
                    abs(int(_wrap_half(int(up_bin[g]) - b_up_c - params.sync2, n))) <= 1
                    for g in (f + 1, f + 2)):
                sync_end = f + 2
        if sync_end is not None:
            best_i, best_len = ri, rl
            break
    if sync_end is None:
        return CssSync(0, 0.0, 0, False)
    b_up = int(up_bin[best_i + best_len // 2])

    lo, hi = best_i + 1, best_i + best_len - 1
    if hi > lo:
        rot = up_pk[lo + 1: hi] * np.conj(up_pk[lo: hi - 1])
        eps_frac = float(np.angle(rot.sum()) / (2 * np.pi))
        # the same phase advance read at fixed bins (b_up and its two
        # neighbours) for every frame: a tone half a bin off puts the
        # argmax on either side frame by frame, which the peaks' phases
        # do not survive, and the fixed bins do
        cols = torch.remainder(torch.arange(b_up - 1, b_up + 2, device=xx.device), n)
        fx = up_spec[lo: hi][:, cols]
        fracs = (eps_frac, float(torch.angle((fx[1:] * fx[:-1].conj()).sum()).cpu()) / (2 * np.pi))
    else:
        eps_frac = 0.0
        fracs = (eps_frac,)

    if (sync_end + 2) * n > int(xx.shape[-1]):
        return CssSync(0, 0.0, 0, False)
    down = frames[sync_end: sync_end + 2] * _chirp(params.upchirp, xx.device)
    dn_spec = torch.fft.fft(down, dim=-1).cpu().numpy()
    pk = np.abs(dn_spec).max(axis=-1)
    b_dn = int(np.argmax(np.abs(dn_spec[int(np.argmax(pk))])))

    s = (b_up + b_dn) % n
    c = min((_wrap_half(s / 2.0 + a, n) for a in (0.0, n / 2.0)), key=abs)
    eps = round(float(c) - eps_frac) + eps_frac
    tau = int(_wrap_half(round(eps) - b_up, n))
    start = (sync_end + 2) * n + tau
    cands = _sync_candidates(n, s, b_up, fracs, sync_end, (start, eps), int(xx.shape[-1]))
    if cands[0] != (start, eps):
        # the reference's frame runs past the capture: nothing to score it on
        return CssSync(start=int(start), cfo_bins=float(eps), tau=int(tau), ok=True)
    sync_e, total_e = _sync_scores(params, xx, cands)
    if sync_e[0] < 0.5 * sync_e.max():
        start, eps = cands[int(np.argmax(total_e))]
        tau = int(_wrap_half(start, n))
    return CssSync(start=int(start), cfo_bins=float(eps), tau=int(tau), ok=True)


def _sync_candidates(n: int, s: int, b_up: int, fracs: tuple, sync_end: int,
                     ref: tuple, length: int) -> list:
    """(start, eps) pairs around the reference's solve, the reference's
    first, each with its preamble tail [start - 4N, start) inside the
    capture: each fractional CFO estimate, both half-N branches of eps = s/2
    mod N/2, the integer bins on either side of each branch's snap, the two
    integer taus around eps - b_up, and the frame grid index of the sync
    word one symbol either way."""
    out = []
    for frac in fracs:
        for a in (0.0, n / 2.0):
            c = float(_wrap_half(s / 2.0 + a, n))
            k0 = round(c - frac)
            for k in (k0, k0 - 1, k0 + 1):
                eps = k + frac
                t = eps - b_up
                for tau in sorted({int(_wrap_half(v, n)) for v in (np.floor(t), np.ceil(t))}):
                    for j in (0, -1, 1):
                        out.append(((sync_end + 2 + j) * n + tau, eps))
    out = [ref] + [c for c in dict.fromkeys(out) if c != ref]
    return [(st, e) for st, e in out if st - 4 * n >= 0 and st <= length]


def _sync_scores(params: CssParams, xx: torch.Tensor, cands: list
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Energy of each candidate's preamble tail at its expected bins, on
    xx's device: the 4N chips before `start` (sync1, sync2, two downchirps),
    derotated by the candidate CFO and correlated symbol by symbol with the
    transmitted ones (the dechirp-DFT value at the expected bin). Returns
    (sync-word energy [C], sync-word + downchirp energy [C]) on the host."""
    n = params.n
    dev = xx.device
    ref = torch.as_tensor(np.conj(css_preamble(params)[-4 * n:]), dtype=CF32, device=dev)
    st = torch.as_tensor([c[0] for c in cands], dtype=torch.int64, device=dev)
    eps = torch.as_tensor([c[1] for c in cands], dtype=torch.float64, device=dev)
    m = torch.arange(4 * n, device=dev)
    seg = xx[st[:, None] - 4 * n + m[None, :]]                         # [C, 4N]
    fr = torch.remainder(eps[:, None] * m[None, :].to(torch.float64) / n, 1.0)
    ph = (-2.0 * np.pi) * fr.to(F32)
    corr = (seg * ref[None, :] * torch.complex(torch.cos(ph), torch.sin(ph))
            ).reshape(len(cands), 4, n).sum(dim=-1)
    e = (corr.real ** 2 + corr.imag ** 2).cpu().numpy().astype(np.float64)
    return e[:, :2].sum(axis=1), e.sum(axis=1)


def css_derotate(params: CssParams, x: torch.Tensor, cfo_bins: float) -> torch.Tensor:
    """Remove a carrier offset of cfo_bins DFT bins (cfo_bins/N cycles per
    chip) from a chip stream (float32 phase ramp, as the reference's)."""
    ph = (-2.0 * np.pi * float(cfo_bins) / params.n) * torch.arange(
        x.shape[-1], dtype=F32, device=x.device)
    return x * torch.complex(torch.cos(ph), torch.sin(ph))


# ---------------------------------------------------------------------------
# bit layer: Gray map + nibble Hamming + diagonal interleaver + whitening
# ---------------------------------------------------------------------------

# Hamming parity equations over a nibble d0..d3 (d0 = MSB). cr parity bits
# are the first cr rows; p0..p2 are the Hamming(7,4) equations and p3 the
# fourth row extending to (8,4).
_PARITY_EQS = np.array([
    [1, 1, 1, 0],   # p0 = d0^d1^d2
    [1, 1, 0, 1],   # p1 = d0^d1^d3
    [1, 0, 1, 1],   # p2 = d0^d2^d3
    [0, 1, 1, 1],   # p3 = d1^d2^d3
], np.int64)


def _parity_eqs(cr: int) -> np.ndarray:
    """cr=1 is the single parity check over all four data bits; cr>=2 the
    Hamming rows above."""
    if cr == 1:
        return np.ones((1, 4), np.int64)
    return _PARITY_EQS[:cr]


def hamming_encode_nibbles(nibbles: np.ndarray, cr: int) -> np.ndarray:
    """Nibbles [K, 4] (bits, MSB first) -> codewords [K, 4+cr] (data then
    parity)."""
    nib = np.asarray(nibbles, np.int64)
    par = (nib @ _parity_eqs(cr).T) & 1
    return np.concatenate([nib, par], axis=-1)


def hamming_decode_nibbles(cw: np.ndarray, cr: int) -> np.ndarray:
    """Codewords [K, 4+cr] -> nibbles [K, 4], correcting single bit errors
    when cr >= 3 by a syndrome over p0..p2 (cr <= 2 passes the data bits).

    As in the reference, cr = 4 decodes with p0..p2 too, so a double error is
    miscorrected to another nibble, not detected as SEC-DED would; the frame
    CRC-16 rejects such a frame."""
    cw = np.asarray(cw, np.int64)
    data, par = cw[:, :4], cw[:, 4:]
    if cr < 3:
        return data
    syn = ((data @ _PARITY_EQS[:3].T) & 1) ^ par[:, :3]   # [K, 3]
    h_cols = np.concatenate([_PARITY_EQS[:3], np.eye(3, dtype=np.int64)], axis=1)
    syn_int = syn @ (1 << np.arange(3))
    col_int = (h_cols * (1 << np.arange(3))[:, None]).sum(0)  # [7]
    pos = np.full(8, -1, np.int64)
    for j, c in enumerate(col_int):
        pos[c] = j
    err = pos[syn_int]                                     # [K]
    out = data.copy()
    for j in range(4):                                     # flip data errors
        out[:, j] ^= (err == j)
    return out


def bits_to_nibbles(bits: np.ndarray) -> np.ndarray:
    """Bit vector (len % 4 == 0) -> [K, 4] nibbles, MSB first."""
    return np.asarray(bits, np.int64).reshape(-1, 4)


def gray_encode_shift(w: np.ndarray) -> np.ndarray:
    """Data word -> transmitted shift k with gray(k) = w (inverse Gray by
    prefix XOR)."""
    w = np.asarray(w, np.int64)
    k = w.copy()
    s = w >> 1
    while s.any():
        k ^= s
        s >>= 1
    return k


def gray_decode_shift(k: np.ndarray) -> np.ndarray:
    """Received shift -> data word: w = k ^ (k >> 1)."""
    k = np.asarray(k, np.int64)
    return k ^ (k >> 1)


def diag_interleave(cw: np.ndarray, sf: int) -> np.ndarray:
    """One block: SF codewords x (4+cr) bits -> (4+cr) symbols x SF bits,
    out[c, r] = cw[(r + c) mod SF, c]."""
    cw = np.asarray(cw, np.int64)
    nsym = cw.shape[1]
    out = np.empty((nsym, sf), np.int64)
    for c in range(nsym):
        out[c] = cw[(np.arange(sf) + c) % sf, c]
    return out


def diag_deinterleave(sym_bits: np.ndarray, sf: int) -> np.ndarray:
    """Inverse of diag_interleave: [(4+cr), SF] -> [SF, 4+cr]."""
    sym_bits = np.asarray(sym_bits, np.int64)
    nsym = sym_bits.shape[0]
    cw = np.empty((sf, nsym), np.int64)
    for c in range(nsym):
        cw[(np.arange(sf) + c) % sf, c] = sym_bits[c]
    return cw


def whitening_seq(nbits: int, seed: int = 0x1FF) -> np.ndarray:
    """Whitening PN bits from a 9-bit Fibonacci LFSR x^9 + x^5 + 1 (LSB out,
    right-shift register, seeded all ones)."""
    state = seed & 0x1FF
    out = np.empty(nbits, np.int64)
    for i in range(nbits):
        out[i] = state & 1
        fb = ((state >> 0) ^ (state >> 4)) & 1     # taps 9, 5
        state = (state >> 1) | (fb << 8)
    return out


_CRC16 = make_crc(0x1021, 16, init=0xFFFF)    # CRC-16/CCITT-FALSE


def _crc16_rows(bits: np.ndarray) -> np.ndarray:
    """CRC-16 of each row of bits [B, N] (MSB first), int64 [B]: the port's
    gf2 engine, as the reference runs its own, on the CPU (the codec is host
    code)."""
    bits = np.asarray(bits, np.int64)
    s = crc_init(_CRC16, device="cpu").expand(bits.shape[0], -1)
    s = crc_update(_CRC16, s, torch.as_tensor(bits))
    return crc_value(_CRC16, s).numpy()


def crc16_ccitt(bits: np.ndarray) -> int:
    """CRC-16/CCITT-FALSE over a bit vector (MSB first): poly 0x1021, init
    0xFFFF, no reflection, no final XOR."""
    return int(_crc16_rows(np.asarray(bits, np.int64).reshape(1, -1))[0])


# ---------------------------------------------------------------------------
# frame layer
# ---------------------------------------------------------------------------

def css_encode_frame(params: CssParams, payload: bytes) -> np.ndarray:
    """Payload bytes -> symbol shifts [S] (implicit-header mode): bytes ->
    bits -> +CRC16 -> whiten -> pad to whole interleaver blocks -> nibble
    Hamming(4+cr) -> diagonal interleave -> Gray -> shifts."""
    sf, cr = params.sf, params.cr
    bits = np.unpackbits(np.frombuffer(payload, np.uint8)).astype(np.int64)
    crc = crc16_ccitt(bits)
    crc_bits = (crc >> (15 - np.arange(16))) & 1
    body = np.concatenate([bits, crc_bits])
    body = body ^ whitening_seq(body.size)
    blk_nib = sf                       # nibbles (codewords) per block
    nnib = -(-body.size // 4)
    nblk = -(-nnib // blk_nib)
    pad = nblk * blk_nib * 4 - body.size
    body = np.concatenate([body, np.zeros(pad, np.int64)])
    cw = hamming_encode_nibbles(bits_to_nibbles(body), cr)  # [K, 4+cr]
    shifts = []
    for b in range(nblk):
        sym_bits = diag_interleave(cw[b * sf: (b + 1) * sf], sf)
        w = sym_bits @ (1 << (sf - 1 - np.arange(sf)))      # MSB first
        shifts.append(gray_encode_shift(w))
    return np.concatenate(shifts)


def css_frame_nsym(params: CssParams, payload_len: int) -> int:
    """Symbol count css_encode_frame produces for payload_len bytes."""
    nbits = payload_len * 8 + 16
    nblk = -(-(-(-nbits // 4)) // params.sf)
    return nblk * (4 + params.cr)


def _check_frame(body: np.ndarray, payload_len: int):
    """De-whiten a decoded body, check its CRC: (payload | None, ok)."""
    nbits = payload_len * 8 + 16
    if body.size < nbits:
        return None, False
    body = body[:nbits] ^ whitening_seq(nbits)
    bits, crc_bits = body[:-16], body[-16:]
    crc_rx = int(crc_bits @ (1 << (15 - np.arange(16))))
    ok = crc16_ccitt(bits) == crc_rx
    payload = np.packbits(bits.astype(np.uint8)).tobytes()
    return (payload if ok else None), ok


def css_decode_frame(params: CssParams, shifts, payload_len: int):
    """Symbol shifts [S] -> (payload bytes | None, crc_ok) (host numpy)."""
    sf, cr = params.sf, params.cr
    nsym_blk = 4 + cr
    shifts = np.asarray(torch.as_tensor(shifts).cpu(), np.int64)
    nblk = shifts.size // nsym_blk
    cws = []
    for b in range(nblk):
        w = gray_decode_shift(shifts[b * nsym_blk: (b + 1) * nsym_blk])
        sym_bits = ((w[:, None] >> (sf - 1 - np.arange(sf))) & 1)
        cws.append(hamming_decode_nibbles(diag_deinterleave(sym_bits, sf), cr))
    body = np.concatenate(cws).reshape(-1) if cws else np.zeros(0, np.int64)
    return _check_frame(body, payload_len)


# ---------------------------------------------------------------------------
# full link
# ---------------------------------------------------------------------------

def css_transmit(params: CssParams, payload: bytes) -> np.ndarray:
    """Payload -> full burst waveform (preamble + sync + downchirps + payload
    symbols), complex64 chips."""
    return np.concatenate([css_preamble(params),
                           css_modulate(params, css_encode_frame(params, payload))])


def css_receive(params: CssParams, x, payload_len: int, device=None):
    """Burst receiver: sync -> derotate -> demod -> decode. Returns
    (payload bytes | None, crc_ok, CssSync). The stages run on x's device (a
    non-tensor x goes to `device`, None = the card)."""
    xx = as_tensor_on(x, device, CF32)
    sync = css_sync(params, xx)
    if not sync.ok:
        return None, False, sync
    nsym = css_frame_nsym(params, payload_len)
    need = sync.start + nsym * params.n
    if need > int(xx.shape[-1]) or sync.start < 0:
        return None, False, sync
    seg = css_derotate(params, xx[sync.start: need], sync.cfo_bins)
    shifts, _ = css_demod(params, seg)
    payload, ok = css_decode_frame(params, shifts, payload_len)
    return payload, ok, sync


def _gray_bit_masks(params: CssParams) -> np.ndarray:
    """[sf, N] bool: bit b (MSB first) of the data word gray(k) is 0 at bin k."""
    words = gray_decode_shift(np.arange(params.n))
    return np.stack([((words >> (params.sf - 1 - b)) & 1) == 0 for b in range(params.sf)])


def css_soft_llrs(params: CssParams, x: torch.Tensor) -> torch.Tensor:
    """An aligned chip stream [S*N] -> per-Gray-data-bit LLRs [S, sf] float32
    on x's device (positive = bit 0): LLR_b = max_{k: bit=0}|S_k| - max_{k:
    bit=1}|S_k| over the dechirped spectrum, one masked max pair per bit."""
    mags = torch.abs(torch.fft.fft(css_frames(params, x), dim=-1))     # [S, N]
    m0 = torch.as_tensor(_gray_bit_masks(params), device=x.device)     # [sf, N]
    neg = torch.tensor(-np.inf, dtype=mags.dtype, device=x.device)
    hi0 = torch.amax(torch.where(m0[:, None, :], mags[None], neg), dim=-1)
    hi1 = torch.amax(torch.where(m0[:, None, :], neg, mags[None]), dim=-1)
    return (hi0 - hi1).T.to(F32)


def _nibbles() -> np.ndarray:
    """[16, 4] the nibbles 0..15 as bits, MSB first."""
    return (np.arange(16)[:, None] >> (3 - np.arange(4))) & 1


def css_decode_frame_soft(params: CssParams, llrs, payload_len: int):
    """Soft frame decode (host numpy): LLRs [S, sf] -> (payload | None,
    crc_ok). Deinterleaves like the hard path, then decodes each nibble by
    exhaustive max-correlation against all 16 codewords of the (4+cr, 4)
    code (ML for the nibble codes)."""
    sf, cr = params.sf, params.cr
    nsym_blk = 4 + cr
    llrs = np.asarray(torch.as_tensor(llrs).cpu(), np.float64)
    nblk = llrs.shape[0] // nsym_blk
    nibs = _nibbles()
    cws = 1.0 - 2.0 * hamming_encode_nibbles(nibs, cr)      # [16, 4+cr]
    out_bits = []
    for blk in range(nblk):
        sym_llr = llrs[blk * nsym_blk: (blk + 1) * nsym_blk]  # [4+cr, sf]
        cw_llr = np.empty((sf, nsym_blk))
        for c in range(nsym_blk):
            cw_llr[(np.arange(sf) + c) % sf, c] = sym_llr[c]
        best = np.argmax(cw_llr @ cws.T, axis=1)             # [sf] ML nibble index
        out_bits.append(nibs[best].reshape(-1))
    body = np.concatenate(out_bits) if out_bits else np.zeros(0, np.int64)
    return _check_frame(body, payload_len)


_CRC16_MATS: dict = {}


def _crc16_matrix(nbits: int) -> tuple[np.ndarray, int]:
    """(M [nbits, 16], c0): crc16_ccitt(b) == c0 XOR packMSB(b @ M % 2), the
    GF(2)-affine decomposition, built once per message length from the CRCs
    of the zero message and of each unit vector (one batched engine call)."""
    got = _CRC16_MATS.get(nbits)
    if got is not None:
        return got
    v = _crc16_rows(np.concatenate([np.zeros((1, nbits), np.int64),
                                    np.eye(nbits, dtype=np.int64)]))
    c0 = int(v[0])
    m = ((v[1:, None] ^ c0) >> (15 - np.arange(16))) & 1
    _CRC16_MATS[nbits] = (m, c0)
    return m, c0


def css_decode_frames_soft_batch(params: CssParams, llrs, payload_len: int, device=None):
    """Soft decode of F whole frames at once on the LLRs' device: llrs [F,
    nsym, sf] (a tensor stays on its device; anything else goes to `device`,
    None = the card) -> (payloads [F] list of bytes | None, ok [F] numpy
    bool). The math of css_decode_frame_soft:

    - the deinterleave is one index take, cw_llr[r, c] = blk[c][(r - c) %
      sf];
    - the ML nibble correlation is one float64 product with the 16
      codewords, then `argmax` (first maximum, as np.argmax; float64 as the
      reference's host code, so equal-metric nibbles tie the same way);
    - whitening is an XOR with the host sequence;
    - the CRC-16 is one float64 GF(2) product with `_crc16_matrix`, exact
      (integer sums <= nbits), then mod 2; the reference's XOR reduction of
      distinct powers of two equals their sum, which is what is taken.

    The bits and flags come back in one copy; the payload bytes are packed
    on the host.
    """
    sf, cr = params.sf, params.cr
    nsym_blk = 4 + cr
    llrs = as_tensor_on(llrs, device)
    dev = llrs.device
    f64 = torch.float64
    llrs = llrs.to(f64)
    f_, nsym, _ = llrs.shape
    nblk = nsym // nsym_blk
    nibs = _nibbles()
    cws = torch.as_tensor(1.0 - 2.0 * hamming_encode_nibbles(nibs, cr), dtype=f64, device=dev)
    blk = llrs[:, : nblk * nsym_blk].reshape(f_, nblk, nsym_blk, sf)
    r = torch.arange(sf, device=dev)[:, None]
    c = torch.arange(nsym_blk, device=dev)[None, :]
    cw_llr = blk[:, :, c, torch.remainder(r - c, sf)]          # [F, nblk, sf, 4+cr]
    best = torch.argmax(cw_llr @ cws.T, dim=-1)                 # [F, nblk, sf]
    bits = torch.as_tensor(nibs, device=dev)[best].reshape(f_, -1)   # [F, nblk*sf*4]
    nbits = payload_len * 8 + 16
    wh = torch.as_tensor(whitening_seq(nbits), device=dev)
    pw = torch.as_tensor(1 << (15 - np.arange(16)), device=dev)
    body = bits[:, :nbits] ^ wh[None, :]
    pb, crc_bits = body[:, :-16], body[:, -16:]
    m, c0 = _crc16_matrix(nbits - 16)
    par = torch.remainder(pb.to(f64) @ torch.as_tensor(m, dtype=f64, device=dev), 2.0)
    crcs = (par.to(torch.int64) * pw).sum(dim=1) ^ c0
    oks = crcs == (crc_bits * pw).sum(dim=1)
    host = torch.cat([pb, oks[:, None].to(pb.dtype)], dim=1).to(torch.uint8).cpu().numpy()
    oks_h = host[:, -1].astype(bool)
    payloads = [np.packbits(host[i, :-1]).tobytes() if oks_h[i] else None for i in range(f_)]
    return payloads, oks_h


def css_receive_stream(params: CssParams, x, payload_len: int, max_bursts: int = 64,
                       device=None):
    """Multi-burst receiver: scan a stream for preambles, decode each frame,
    continue past it. Returns a list of (payload bytes | None, crc_ok, start
    chip index), one entry per detected burst. The stream stays on its
    device (a non-tensor x goes to `device`, None = the card); each burst is
    a view of it."""
    xx = as_tensor_on(x, device, CF32)
    total = int(xx.shape[-1])
    nsym = css_frame_nsym(params, payload_len)
    out = []
    off = 0
    while len(out) < max_bursts and total - off >= preamble_len(params):
        payload, ok, sync = css_receive(params, xx[off:], payload_len)
        if not sync.ok:
            break
        out.append((payload, ok, off + sync.start))
        adv = sync.start + (nsym * params.n if ok else 0)
        off += max(adv, params.n)
    return out
