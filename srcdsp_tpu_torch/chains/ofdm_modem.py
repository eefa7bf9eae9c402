"""Coded-OFDM receive modem (counterpart of ``srcdsp_tpu/chains/ofdm_modem.py``):
the multicarrier sibling of ``chains.modem``, the OFDM plane front end with
the bit-plane BICM interleaver and the column-major QC layered LDPC decoder.

    planes [C, K] (aligned, pilot symbol first)
      --(CP strip + active-bin DFT matmul + one-tap EQ + DD common
         phase, chains.ofdm_planes)--> soft subcarrier symbols [C, S, na]
      --(flatten to each channel's symbol stream, one transpose of the
         small symbol planes)--> [spc, C*nw]
      --(demap.qam_llr_bitplanes, concatenated)--> llr_t [n, B]
      --(K15, kernels/ldpc_pallas.make_qc_decoder_t)--> (bits_t, ok)

The TX convention is ``modem.map_codewords_to_symbols`` laid row-major on
the OFDM data grid (symbol s -> OFDM symbol s // n_active, subcarrier
s % n_active); grid slots past the last codeword are filler. On a CUDA
tensor the decoder is K15; on a CPU tensor, K15's plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from srcdsp_tpu_torch.chains.ofdm import OfdmSpec
from srcdsp_tpu_torch.chains.ofdm_planes import make_ofdm_rx_planes
from srcdsp_tpu_torch.demap import qam_llr_bitplanes
from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.kernels.ldpc_pallas import QcPlan, make_qc_decoder_t
from srcdsp_tpu_torch.ldpc import LdpcCode

__all__ = ["make_ofdm_coded_modem"]


def make_ofdm_coded_modem(spec: OfdmSpec, code: LdpcCode, plan: QcPlan, *, num_channels: int,
                          nw: int, iters: int = 6, b_tile: int = 128, n_pilot: int = 1,
                          device=None):
    """Build the coded-OFDM receive pipeline.

    Returns pipeline(yr, yi, pr, pi) -> (bits_t [n, C*nw] int32 column-major,
    ok [C*nw] bool): yr/yi [C, K] aligned sample planes whose first n_pilot
    symbols are the known pilot (pr/pi [n_active] constellation planes);
    channel c carries nw codewords of n = plan.nb*plan.z bits, codeword
    r = c*nw + w in column r. K must cover n_pilot + ceil(nw*spc/n_active)
    OFDM symbols. The reference's precision and interpret options shape only
    its TPU lowering and have no counterpart.
    """
    device = resolve(device)
    na = int(np.asarray(spec.active).size)
    n = plan.nb * plan.z
    bps = int(spec.order).bit_length() - 1
    if n % bps:
        raise ValueError(f"n={n} not a multiple of bits/symbol {bps}")
    spc = n // bps
    batch = num_channels * nw
    if batch % b_tile:
        raise ValueError(f"C*nw = {batch} not a multiple of b_tile {b_tile}")
    rx = make_ofdm_rx_planes(spec, n_pilot=n_pilot, device=device)
    dec = make_qc_decoder_t(code, plan, iters=iters, b_tile=b_tile, device=device)

    def to_cols(z: torch.Tensor) -> torch.Tensor:
        c, s, _ = z.shape
        flat = z.reshape(c, s * na)[:, : nw * spc]
        return flat.reshape(c, nw, spc).permute(2, 0, 1).reshape(spc, batch)

    def pipeline(yr, yi, pr, pi):
        _idx, (zr, zi) = rx(yr, yi, pr, pi)
        llr_t = torch.cat(qam_llr_bitplanes(to_cols(zr), to_cols(zi), spec.order), dim=0)
        return dec(llr_t)

    return pipeline
