"""Extended binary Golay (24, 12, 8) codec (counterpart of
``srcdsp_tpu/golay.py``).

Construction on the host (the reference's numpy, so the tables are equal):
G = [I12 | B] with B the bordered quadratic-residue form over Z11; every
nonzero codeword is enumerated and the minimum weight asserted == 8. The
decoder's syndrome table covers the 2325 patterns of weight <= 3; the other
1771 syndromes are weight-4 cosets, detected and not corrected.

Decoding is one GF(2) matmul for the syndromes ([B, 24] @ [24, 12] mod 2,
float32 with TF32 off) plus one table gather.

The code's tables stay numpy arrays, as the reference's do, and are copied
to the data's device per call (four small copies a decode), as `fec` and
`polar` do with theirs; only RS and BCH, whose reference codes hold device
arrays, are built on a device once.
"""

from __future__ import annotations

from itertools import combinations
from typing import NamedTuple

import numpy as np
import torch

from srcdsp_tpu_torch.ops.fir import pin_f32
from srcdsp_tpu_torch.types import F32

__all__ = ["Golay", "make_golay", "golay_encode", "golay_decode"]


class Golay(NamedTuple):
    g: np.ndarray            # [12, 24] generator (systematic)
    h: np.ndarray            # [24, 12] parity-check (syndrome operator)
    table: np.ndarray        # [4096, 24] int8 error pattern per syndrome
    correctable: np.ndarray  # [4096] bool


def _b_matrix() -> np.ndarray:
    # core[i][j] = 1 iff (i + j) mod 11 is NOT a quadratic residue; the
    # (i + j) argument makes B symmetric, which H = [[B], [I]] relies on
    qr = {1, 3, 4, 5, 9}
    a = np.zeros((11, 11), np.int64)
    for i in range(11):
        for j in range(11):
            a[i, j] = 0 if ((i + j) % 11) in qr else 1
    b = np.ones((12, 12), np.int64)
    b[:11, :11] = a
    b[11, 11] = 0
    return b


def make_golay() -> Golay:
    b = _b_matrix()
    g = np.concatenate([np.eye(12, dtype=np.int64), b], axis=1)
    msgs = ((np.arange(1, 4096)[:, None] >> np.arange(12)) & 1)
    wmin = int((msgs @ g % 2).sum(axis=1).min())
    if wmin != 8:
        raise AssertionError(f"Golay construction broken: d_min {wmin}")
    h = np.concatenate([b.T, np.eye(12, dtype=np.int64)], axis=0)
    assert not (g @ h % 2).any()
    table = np.zeros((4096, 24), np.int8)
    correctable = np.zeros(4096, bool)
    pw = 1 << np.arange(12)
    correctable[0] = True                     # zero errors
    for k in (1, 2, 3):
        for pos in combinations(range(24), k):
            e = np.zeros(24, np.int64)
            e[list(pos)] = 1
            s = int((e @ h % 2) @ pw)
            assert not correctable[s] or s == 0
            table[s] = e
            correctable[s] = True
    assert int(correctable.sum()) == 2325    # perfect coset coverage
    return Golay(g=g, h=h, table=table, correctable=correctable)


def golay_encode(code: Golay, data: torch.Tensor) -> torch.Tensor:
    """Data bits [..., 12] -> codewords [..., 24] int32 (systematic)."""
    d = data.to(F32)
    pin_f32(d)
    g = torch.as_tensor(code.g.astype(np.float32), device=d.device)
    return torch.remainder(d @ g, 2.0).to(torch.int32)


def golay_decode(code: Golay, words: torch.Tensor):
    """Received hard bits [..., 24] -> (data [..., 12] int32, n_corrected
    [...] int32, ok [...] bool: False = weight-4 coset, detected and not
    corrected)."""
    w = words.to(F32)
    pin_f32(w)
    dev = w.device
    syn = torch.remainder(w @ torch.as_tensor(code.h.astype(np.float32), device=dev), 2.0)
    si = (syn @ torch.as_tensor((1 << np.arange(12)).astype(np.float32), device=dev)).to(torch.int64)
    err = torch.as_tensor(code.table.astype(np.int32), device=dev)[si]
    ok = torch.as_tensor(code.correctable, device=dev)[si]
    fixed = torch.remainder(w + err, 2.0).to(torch.int32)
    return fixed[..., :12], err.sum(dim=-1, dtype=torch.int32), ok
