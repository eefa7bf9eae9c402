"""Carry parameters and streaming state between the JAX package and this one.

For this DSP system the "weights" are the taps, the tuning words and the
carried streaming state. The JAX objects are read through their attributes
and ``np.asarray`` (no JAX import here), so a stream started by the JAX
package continues here with no seam; `fsk_state_to_numpy` gives back plain
arrays from which the JAX ``FskState`` is rebuilt.
"""

from __future__ import annotations

import numpy as np
import torch

from srcdsp_tpu_torch.chains.fsk import FskParams, FskState
from srcdsp_tpu_torch.chains.sync import TimingState
from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.ops.fir import FirState
from srcdsp_tpu_torch.ops.nco import NcoState, word_tensor
from srcdsp_tpu_torch.ops.resample import ResampleState


def fsk_params_from(p, device=None) -> FskParams:
    """FskParams from any object with the JAX FskParams fields."""
    device = resolve(device)
    return FskParams(
        freq_word=word_tensor(np.asarray(p.freq_word, np.uint32), device),
        taps=torch.as_tensor(np.array(p.taps, np.float32), device=device),
        decim=int(p.decim), sps=int(p.sps), dev=float(p.dev),
        timing_forget=float(p.timing_forget))


def fsk_params_to_numpy(p: FskParams) -> dict:
    """FskParams as numpy arrays + scalars (freq_word as uint32)."""
    return dict(freq_word=p.freq_word.cpu().numpy().astype(np.uint32),
                taps=p.taps.cpu().numpy(), decim=p.decim, sps=p.sps, dev=p.dev,
                timing_forget=p.timing_forget)


def fsk_state_from(s, device=None) -> FskState:
    """FskState from any object shaped like the JAX FskState
    (s.nco.phase u32, s.fir.tail, s.disc_last, s.timing.acc, s.timing.last)."""
    device = resolve(device)

    def t(a, dtype):
        return torch.as_tensor(np.array(a, dtype), device=device)

    return FskState(
        nco=NcoState(phase=word_tensor(np.asarray(s.nco.phase, np.uint32), device)),
        fir=FirState(tail=t(s.fir.tail, np.complex64)),
        disc_last=t(s.disc_last, np.complex64),
        timing=TimingState(acc=t(s.timing.acc, np.complex64),
                           last=t(s.timing.last, np.float32)))


def fsk_state_to_numpy(s: FskState) -> dict:
    """FskState as numpy arrays, keyed like the JAX fields (nco_phase u32)."""
    def n(a):
        return a.detach().cpu().numpy()

    return dict(nco_phase=n(s.nco.phase).astype(np.uint32), fir_tail=n(s.fir.tail),
                disc_last=n(s.disc_last), timing_acc=n(s.timing.acc),
                timing_last=n(s.timing.last))


def resample_state_from(s, device=None) -> ResampleState:
    """ResampleState from any object with a ``tail`` field (the JAX ResampleState)."""
    return ResampleState(tail=torch.as_tensor(np.array(s.tail, np.complex64),
                                              device=resolve(device)))


def config2_state_from(states, device=None) -> tuple[NcoState, FirState, ResampleState]:
    """The config-2 chain's carried state (nco, fir, resample), as the JAX
    ``build_config2`` step takes and returns it, for the port's step."""
    device = resolve(device)
    nco_s, fir_s, rs_s = states
    return (NcoState(phase=word_tensor(np.asarray(nco_s.phase, np.uint32), device)),
            FirState(tail=torch.as_tensor(np.array(fir_s.tail, np.complex64), device=device)),
            resample_state_from(rs_s, device))

