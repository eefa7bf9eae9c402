"""GF(2) linear sequence machines: LFSR scramblers and CRCs as f32 matmuls
(counterpart of ``srcdsp_tpu/gf2.py``).

Every LFSR and CRC is a linear system over GF(2),

    s[t+1] = (A s[t] + B u[t]) mod 2,    y[t] = (C s[t] + D u[t]) mod 2,

so whole L-bit blocks run as float32 matmuls followed by mod 2 with the
host-built block matrices (the reference's numpy, so they are equal)

    G [L, p] rows C A^j,  H [L, L] lower-triangular C A^(i-j-1) B (diag D),
    F [p, L] cols A^(L-1-i) B,  A^L.

Entries are 0/1 and sums stay below 2^24, so every product is exact in
float32 (TF32 is pinned off anyway, `ops.fir.pin_f32`). The reference's
`lax.scan` over blocks becomes a loop over the [p] state chain only: the
input's share of every block's next state is one batched matmul before the
loop, and every block's outputs one batched matmul after it. A ragged tail
uses its own tail-length matrices, with no padding, so any split of a stream
gives the same bits.

CRC values come back as int64 tensors holding the unsigned 32-bit value.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.ops.fir import pin_f32
from srcdsp_tpu_torch.types import F32

I32 = torch.int32


class Gf2Params(NamedTuple):
    """Block matrices for one GF(2) machine at one length L, float32 on a device."""

    al: torch.Tensor    # [p, p] A^L mod 2
    f: torch.Tensor     # [p, L] input -> next state
    g: torch.Tensor     # [L, p] entry state -> outputs
    h: torch.Tensor     # [L, L] inputs -> outputs (lower-triangular)


class Gf2Machine:
    """Host spec (A, B, C, D over GF(2)) with a per-length matrix cache.

    The matrices of each block length are built once in exact numpy mod-2
    arithmetic and moved once to each device that asks for them.
    """

    def __init__(self, a: np.ndarray, b: np.ndarray, c: np.ndarray,
                 d: int, block: int = 512):
        self.a = np.asarray(a, np.uint8) & 1
        self.b = (np.asarray(b, np.uint8) & 1).reshape(-1)
        self.c = (np.asarray(c, np.uint8) & 1).reshape(-1)
        self.d = int(d) & 1
        self.p = self.a.shape[0]
        self.block = int(block)
        if self.a.shape != (self.p, self.p) or self.b.size != self.p \
                or self.c.size != self.p:
            raise ValueError("inconsistent A/B/C shapes")
        self._host: dict[int, tuple[np.ndarray, ...]] = {}
        self._dev: dict[tuple[int, torch.device], Gf2Params] = {}

    def host_matrices(self, length: int) -> tuple[np.ndarray, ...]:
        """(A^L, F, G, H) as uint8 numpy arrays."""
        if length not in self._host:
            self._host[length] = self._build(length)
        return self._host[length]

    def matrices(self, length: int, device) -> Gf2Params:
        device = torch.device(device)
        key = (length, device)
        if key not in self._dev:
            self._dev[key] = Gf2Params(*(torch.as_tensor(m.astype(np.float32), device=device)
                                         for m in self.host_matrices(length)))
        return self._dev[key]

    def _build(self, length: int) -> tuple[np.ndarray, ...]:
        a, b, c, p = self.a, self.b, self.c, self.p
        pw = np.empty((length + 1, p, p), np.uint8)
        pw[0] = np.eye(p, dtype=np.uint8)
        for j in range(1, length + 1):
            pw[j] = (pw[j - 1] @ a) & 1
        g = np.empty((length, p), np.uint8)
        f = np.empty((p, length), np.uint8)
        h = np.zeros((length, length), np.uint8)
        cab = np.empty((length, p), np.uint8)      # rows c @ A^j (for H)
        for j in range(length):
            g[j] = (c @ pw[j]) & 1
            f[:, length - 1 - j] = (pw[j] @ b) & 1
            cab[j] = g[j]
            if self.d:
                h[j, j] = 1
        v = (cab.astype(np.int64) @ b) & 1                 # C A^k B
        i, j = np.tril_indices(length, -1)
        h[i, j] = v[i - j - 1]
        return pw[length], f, g, h


def gf2_init(machine: Gf2Machine, state_bits: int | Sequence[int], device=None) -> torch.Tensor:
    """Initial state vector [p] float32 from an integer (bit i -> s_i) or a
    bit list, on `device` (the card unless it says otherwise)."""
    if isinstance(state_bits, (int, np.integer)):
        bits = [(int(state_bits) >> i) & 1 for i in range(machine.p)]
    else:
        bits = list(state_bits)
        if len(bits) != machine.p:
            raise ValueError("state bit list length != p")
    return torch.tensor(bits, dtype=F32, device=resolve(device))


def _apply_one(par: Gf2Params, s: torch.Tensor, ub: torch.Tensor):
    """One length-L segment: ub [..., L] -> (s', y [..., L])."""
    y = torch.remainder(ub @ par.h.T + s @ par.g.T, 2.0)
    s_n = torch.remainder(ub @ par.f.T + s @ par.al.T, 2.0)
    return s_n, y


def gf2_apply(machine: Gf2Machine, s: torch.Tensor,
              u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the machine over bits u [..., N] (any N >= 0) from state s [..., p].

    Returns (state', y [..., N] as 0/1 int32). Full blocks: the inputs' state
    terms F u_k in one batched matmul, the [p] chain s_k+1 = (F u_k + A^L s_k)
    mod 2 in a loop of small matvecs, then every block's outputs
    (H u_k + G s_k) mod 2 in one batched matmul. A ragged tail uses exact
    tail-length matrices.
    """
    u = u.to(F32)
    s = s.to(device=u.device, dtype=F32)
    pin_f32(u)
    lead = tuple(u.shape[:-1])
    n = u.shape[-1]
    l = machine.block
    k, tail = divmod(n, l)
    outs = []
    if k:
        par = machine.matrices(l, u.device)
        ub = u[..., : k * l].reshape(*lead, k, l)                # [..., K, L]
        fu = ub @ par.f.T                                       # [..., K, p]
        entry = []
        for j in range(k):
            entry.append(s)
            s = torch.remainder(fu[..., j, :] + s @ par.al.T, 2.0)
        shape = torch.broadcast_shapes(*(e.shape for e in entry))
        se = torch.stack([e.expand(shape) for e in entry], dim=-2)   # [..., K, p]
        yb = torch.remainder(ub @ par.h.T + se @ par.g.T, 2.0)
        outs.append(yb.reshape(*yb.shape[:-2], k * l))
    if tail:
        s, y_t = _apply_one(machine.matrices(tail, u.device), s, u[..., k * l:])
        outs.append(y_t)
    if not outs:
        return s, torch.zeros(lead + (0,), dtype=I32, device=u.device)
    return s, torch.cat(outs, dim=-1).to(I32)


# ---------------------------------------------------------------------------
# Additive scrambler (free-running LFSR keystream XORed onto the data)
# ---------------------------------------------------------------------------

def make_scrambler(taps: Sequence[int], order: int, block: int = 512) -> Gf2Machine:
    """Fibonacci LFSR keystream generator.

    State bit s_i (stored at index i-1) is the feedback value delayed i
    steps; the output is the feedback, the XOR of s_i for i in `taps`.
    802.11: ``make_scrambler((4, 7), 7)`` (x^7 + x^4 + 1); DVB:
    ``make_scrambler((14, 15), 15)``.
    """
    p = int(order)
    fb = np.zeros(p, np.uint8)
    for t in taps:
        if not 1 <= t <= p:
            raise ValueError("tap outside register")
        fb[t - 1] = 1
    a = np.zeros((p, p), np.uint8)
    a[0] = fb                    # s_1' = feedback
    for i in range(1, p):
        a[i, i - 1] = 1          # shift
    return Gf2Machine(a, np.zeros(p), fb, 0, block)


def scramble(machine: Gf2Machine, s: torch.Tensor,
             bits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """XOR the keystream onto bits [..., N]. Self-inverse (descrambles)."""
    zeros = torch.zeros(bits.shape, dtype=F32, device=bits.device)
    s_fin, key = gf2_apply(machine, s, zeros)
    return s_fin, torch.bitwise_xor(bits.to(I32), key)


# ---------------------------------------------------------------------------
# CRC
# ---------------------------------------------------------------------------

class CrcSpec(NamedTuple):
    machine: Gf2Machine
    width: int
    init: int
    xorout: int
    reflect: bool


def make_crc(poly: int, width: int, init: int = 0, xorout: int = 0,
             reflect: bool = False, block: int = 512) -> CrcSpec:
    """Generic CRC. `poly` excludes the top x^width term (e.g. CCITT 0x1021).

    reflect=True gives the reflected (LSB-first) family: CRC-32 is
    ``make_crc(0x04C11DB7, 32, 0xFFFFFFFF, 0xFFFFFFFF, reflect=True)`` fed
    with LSB-first bits per byte (`bytes_to_bits(..., lsb_first=True)`).
    """
    p = int(width)
    if not 1 <= p <= 32:
        raise ValueError("CRC width must be in [1, 32]")
    a = np.zeros((p, p), np.uint8)
    b = np.zeros(p, np.uint8)
    # register bits r_0..r_{p-1} (r_{p-1} = MSB). Per input bit u:
    #   fb = r_{p-1} ^ u ;  r' = (r << 1) ^ (fb ? poly : 0)
    for i in range(p):
        if i > 0:
            a[i, i - 1] = 1
        if (poly >> i) & 1:
            a[i, p - 1] ^= 1
            b[i] = 1
    return CrcSpec(machine=Gf2Machine(a, b, np.zeros(p), 0, block),
                   width=p, init=init, xorout=xorout, reflect=bool(reflect))


def crc_init(spec: CrcSpec, device=None) -> torch.Tensor:
    """The register at `spec.init`, [width] float32 on `device` (the card
    unless it says otherwise)."""
    return gf2_init(spec.machine, spec.init, device=device)


def crc_update(spec: CrcSpec, s: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Absorb bits [..., N] (MSB-first per byte; LSB-first when reflected).
    Returns the new register [..., width]: stream by chaining calls."""
    s_fin, _ = gf2_apply(spec.machine, s, bits)
    return s_fin


def crc_value(spec: CrcSpec, s: torch.Tensor) -> torch.Tensor:
    """Register [..., width] -> the CRC (reflection and xorout applied), an
    int64 tensor holding the unsigned value."""
    bits = torch.round(s).to(torch.int64)               # s_i = bit i
    idx = np.arange(spec.width)
    if spec.reflect:
        idx = idx[::-1].copy()                          # bit-reverse output
    weights = torch.as_tensor(np.int64(1) << idx.astype(np.int64), device=s.device)
    return torch.bitwise_xor((bits * weights).sum(dim=-1), int(spec.xorout))


def bytes_to_bits(data: bytes, lsb_first: bool = False) -> np.ndarray:
    """Byte string -> 0/1 int32 bit array (host); lsb_first=True for
    reflected CRCs."""
    arr = np.frombuffer(data, np.uint8)
    bits = np.unpackbits(arr.reshape(-1, 1), axis=1)
    if lsb_first:
        bits = bits[:, ::-1]
    return bits.reshape(-1).astype(np.int32)


def byte_tensor_bits(x: torch.Tensor, lsb_first: bool = False) -> torch.Tensor:
    """uint8 bytes [..., S] -> 0/1 int32 bits [..., 8S] on the same device
    (`bytes_to_bits` for tensors): MSB first per byte, or LSB first."""
    sh = torch.arange(8, device=x.device) if lsb_first else torch.arange(7, -1, -1, device=x.device)
    bits = (x.to(I32)[..., None] >> sh.to(I32)) & 1
    return bits.reshape(*x.shape[:-1], 8 * x.shape[-1])
