"""Digital down-converter: tune + filter + decimate to the least rate,
auto-designed (counterpart of ``srcdsp_tpu/ops/ddc.py``).

The u32-exact NCO (``ops.nco``) followed by the multistage decimation plan
(``ops.decimplan``):

    ddc = make_ddc(center=0.21, bandwidth=0.004, atten_db=70)
    state = ddc_init(ddc)
    state, y = ddc_apply(ddc, state, block)   # y at rate fs/ddc.decim

The factor is the largest D with the protected band [0, bandwidth/2] inside
(0, 0.5/D) and a guard fraction of the output Nyquist left for the
transition, capped by `max_decim`. The params are host values (a u32 word
and the plan's numpy taps), so `make_ddc` takes no device; `ddc_init` puts
the state on one.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from srcdsp_tpu_torch.ops.decimplan import (
    DecimPlan, DecimPlanState, decim_plan_apply, decim_plan_init, plan_decimation)
from srcdsp_tpu_torch.ops.nco import NcoState, freq_to_word, nco_apply, nco_init

__all__ = ["DdcParams", "DdcState", "make_ddc", "ddc_init", "ddc_apply"]


class DdcParams(NamedTuple):
    freq_word: np.uint32
    plan: DecimPlan
    decim: int


class DdcState(NamedTuple):
    nco: NcoState
    plan: DecimPlanState


def make_ddc(center: float, bandwidth: float, atten_db: float = 70.0, guard: float = 0.25,
             max_decim: int = 4096) -> DdcParams:
    """center/bandwidth in cycles/sample at the input rate. `guard` is the
    fraction of the output Nyquist left for the transition band (passband
    edge <= (1-guard) * 0.5/D)."""
    half_bw = bandwidth / 2.0
    if not 0.0 < half_bw < 0.5 * (1.0 - guard):
        raise ValueError(f"bandwidth {bandwidth} not in (0, {1.0 - guard})")
    d = int((1.0 - guard) * 0.5 / half_bw)
    d = max(1, min(d, max_decim))
    while d > 1 and not 0.0 < half_bw < 0.5 / d:
        d -= 1
    if d < 2:
        raise ValueError("bandwidth too wide to decimate: filter directly")
    plan = plan_decimation(d, passband=half_bw, atten_db=atten_db)
    return DdcParams(freq_word=freq_to_word(-center), plan=plan, decim=d)


def ddc_init(params: DdcParams, channel_shape: tuple = (), device=None) -> DdcState:
    return DdcState(nco=nco_init(channel_shape, device=device),
                    plan=decim_plan_init(params.plan, channel_shape, device=device))


def ddc_apply(params: DdcParams, state: DdcState, x: torch.Tensor
              ) -> tuple[DdcState, torch.Tensor]:
    """x: [..., N] with N % decim == 0 -> [..., N/decim] at baseband."""
    nco_s, mixed = nco_apply(params.freq_word, state.nco, x)
    plan_s, y = decim_plan_apply(params.plan, state.plan, mixed)
    return DdcState(nco=nco_s, plan=plan_s), y
