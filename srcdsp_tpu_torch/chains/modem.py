"""Coherent coded modem, receive side (counterpart of
``srcdsp_tpu/chains/modem.py``):

    planes [C, 2, hist+N]
      --(K1 mc, kernels/mixfir: NCO mix + RRC matched filter + decimate to
         the symbol rate)--> symbol planes [C, N/sps]
      --(one transpose of the symbol planes to [spc, C*nw])-->
      --(demap.qam_llr_bitplanes, concatenated on the codeword axis)-->
         llr_t [n, C*nw]
      --(K15, kernels/ldpc_pallas.make_qc_decoder_t)--> (bits_t, ok)

The layout is the reference's: a bit-plane interleaver (symbol s of a
codeword carries label bit b, MSB first, from cw[b*spc + s],
`map_codewords_to_symbols`), so the LLRs are a concatenation of the demap
planes, and the decoder reads and writes column-major with no transpose.
This is the stationary tier (fixed tuning words, known symbol phase): `lag`,
the matched-filter cascade's delay in symbols, is a build argument.
"""

from __future__ import annotations

import numpy as np
import torch

from srcdsp_tpu_torch.demap import qam_llr_bitplanes
from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.kernels.ldpc_pallas import QcPlan, make_qc_decoder_t
from srcdsp_tpu_torch.kernels.mixfir import make_mix_fir_kernel_mc, mix_fir_decim_mc
from srcdsp_tpu_torch.ldpc import LdpcCode


def map_codewords_to_symbols(cw: torch.Tensor, order: int) -> torch.Tensor:
    """TX-side bit-plane mapping: cw [..., n] -> Gray symbol indices
    [..., n/log2(order)] int32, symbol s taking label bit b (MSB first) from
    cw[..., b*spc + s]."""
    cw = torch.as_tensor(cw)
    bps = int(order).bit_length() - 1
    n = cw.shape[-1]
    if n % bps:
        raise ValueError(f"n={n} not a multiple of bits/symbol {bps}")
    planes = cw.to(torch.int32).reshape(*cw.shape[:-1], bps, n // bps)
    w = torch.as_tensor(2 ** np.arange(bps - 1, -1, -1), dtype=torch.int32, device=cw.device)
    return torch.sum(planes * w[:, None], dim=-2, dtype=torch.int32)


def make_coherent_modem(taps, dwords, sps: int, order: int, code: LdpcCode, plan: QcPlan, *,
                        nw: int, lag: int = 0, iters: int = 6, out_tile: int = 512,
                        b_rows: int = 32, b_tile: int = 128, device=None):
    """Build the coherent QAM coded receive pipeline.

    taps: RRC matched filter (decimation `sps` takes the front end to the
    symbol rate); dwords: [C] u32 tuning words; order: square QAM size;
    code/plan: the QC LDPC pair; nw: codewords per channel per call
    (C*nw % b_tile == 0); lag: symbol offset of the first codeword symbol.

    Returns (pipeline, hist): pipeline(planes [C, 2, hist+N]) -> (bits_t
    [n, C*nw] int32, codeword r = c*nw + w in column r, ok [C*nw] bool). N/sps
    must cover lag + nw*n/log2(order) symbols and be a multiple of
    b_rows*out_tile. The reference's precision and interpret options shape
    only the Pallas lowering and have no counterpart.
    """
    device = resolve(device)
    dwords = np.asarray(dwords, np.uint32)
    num_channels = int(dwords.shape[0])
    n = plan.nb * plan.z
    bps = int(order).bit_length() - 1
    if n % bps:
        raise ValueError(f"n={n} not a multiple of bits/symbol {bps}")
    spc = n // bps
    batch = num_channels * nw
    if batch % b_tile:
        raise ValueError(f"C*nw = {batch} not a multiple of b_tile {b_tile}")
    kernel = make_mix_fir_kernel_mc(taps, sps, num_channels, out_tile=out_tile, b_rows=b_rows,
                                    device=device)
    dec = make_qc_decoder_t(code, plan, iters=iters, b_tile=b_tile, device=device)
    # plane index 0 is global sample -hist: the words back the phase up by hist
    words0 = np.asarray([(-kernel.hist * int(w)) % (1 << 32) for w in dwords], np.uint32)

    def to_cols(y: torch.Tensor) -> torch.Tensor:
        y = y[:, lag:lag + nw * spc]
        return y.reshape(num_channels, nw, spc).permute(2, 0, 1).reshape(spc, batch)

    def pipeline(planes: torch.Tensor):
        yr, yi = mix_fir_decim_mc(kernel, words0, dwords, planes)
        llr_t = torch.cat(qam_llr_bitplanes(to_cols(yr), to_cols(yi), order), dim=0)
        return dec(llr_t)

    return pipeline, kernel.hist
