"""Multi-stage decimation planner (counterpart of ``srcdsp_tpu/ops/decimplan.py``).

A decimate-by-D filter protecting a narrow passband needs its tap count set
by the final transition width; run at the input rate, one such FIR is the
expensive way. The plan is a cascade: half-band stages (``ops.halfband``)
burn down the powers of two at ever-halving rates, and one general polyphase
stage (``ops.fir``) takes the odd residual with the tight spec at the lowest
rate:

    plan = plan_decimation(decim=48, passband=0.008, atten_db=70)
    state = decim_plan_init(plan)
    state, y = decim_plan_apply(plan, state, x)     # streaming, carried

The plan's contract is alias protection of the passband [0, passband]: every
frequency that folds onto it after the full decimation is attenuated by at
least atten_db. Design is host numpy, a copy of the JAX module's, so the two
packages build the same plan; the final taps are float32, as there.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from srcdsp_tpu_torch.ops.design import kaiser_num_taps
from srcdsp_tpu_torch.ops.fir import FirState, fir_apply, fir_init
from srcdsp_tpu_torch.ops.halfband import cascade_apply, cascade_init, design_halfband
from srcdsp_tpu_torch.ops.window import lowpass
from srcdsp_tpu_torch.types import CF32

__all__ = ["DecimPlan", "DecimPlanState", "plan_decimation", "decim_plan_init",
           "decim_plan_apply", "plan_response", "single_stage_taps"]


class DecimPlan(NamedTuple):
    """halfband_taps: per-stage designs (highest rate first). final_taps /
    final_decim: the residual polyphase stage (None / 1 when the factor is a
    power of two). macs_per_input: real MACs per input sample. decim: total
    factor."""

    halfband_taps: tuple
    final_taps: np.ndarray | None
    final_decim: int
    decim: int
    passband: float
    atten_db: float
    macs_per_input: float


class DecimPlanState(NamedTuple):
    hb: tuple                 # tuple[HalfbandState, ...]
    fir: FirState | None


def _round_4k3(n: int) -> int:
    """Smallest half-band-legal tap count (4k+3) >= n."""
    return n + (3 - n) % 4


def single_stage_taps(decim: int, passband: float, atten_db: float) -> int:
    """Tap count of the single-stage equivalent: transition from `passband`
    to the first alias edge 1/decim - passband, at the full input rate."""
    transition = max(1.0 / decim - 2.0 * passband, 1e-6)
    return kaiser_num_taps(atten_db, transition)


def plan_decimation(decim: int, passband: float, atten_db: float = 70.0) -> DecimPlan:
    """Design a multistage decimator: half-bands for the 2^k factor, one
    general polyphase stage for the odd residual.

    passband: protected band edge in cycles/sample at the input rate (must be
    < 0.5/decim). atten_db: least attenuation of everything aliasing onto
    [0, passband]. Each stage is designed with a 5 dB margin over Kaiser's
    tap-count estimate.
    """
    if decim < 2:
        raise ValueError("decim must be >= 2")
    if not 0.0 < passband < 0.5 / decim:
        raise ValueError(f"passband {passband} must lie in (0, {0.5 / decim}"
                         f") for decim {decim}")
    k = 0
    residual = decim
    while residual % 2 == 0:
        residual //= 2
        k += 1
    atten = atten_db + 5.0

    hb = []
    macs = 0.0
    rate = 1.0                       # current rate in input-rate units
    for _ in range(k):
        fp = passband / rate
        # the stopband starts where the next octave folds onto the passband
        transition = 0.5 - 2.0 * fp
        n = _round_4k3(kaiser_num_taps(atten, transition))
        hb.append(design_halfband(n, atten_db=atten))
        # polyphase half-band: (n+1)/2 + 1 nonzero taps, output rate rate/2
        macs += (rate / 2.0) * ((n + 1) // 2 + 1)
        rate /= 2.0

    if residual > 1:
        fp = passband / rate
        stop = 1.0 / residual - fp   # first alias edge at the final rate
        transition = max(stop - fp, 1e-6)
        n = kaiser_num_taps(atten, transition)
        final = lowpass(n, 0.5 * (fp + stop), window="kaiser", atten_db=atten)
        macs += (rate / residual) * n
        final = np.asarray(final, np.float32)
    else:
        final = None
    return DecimPlan(halfband_taps=tuple(hb), final_taps=final, final_decim=residual,
                     decim=decim, passband=passband, atten_db=atten_db,
                     macs_per_input=float(macs))


def decim_plan_init(plan: DecimPlan, channel_shape: tuple = (), dtype=CF32,
                    device=None) -> DecimPlanState:
    return DecimPlanState(
        hb=cascade_init(plan.halfband_taps, channel_shape, dtype, device),
        fir=(fir_init(len(plan.final_taps), channel_shape, dtype=dtype, device=device)
             if plan.final_taps is not None else None))


def decim_plan_apply(plan: DecimPlan, state: DecimPlanState, x: torch.Tensor
                     ) -> tuple[DecimPlanState, torch.Tensor]:
    """Run one block through the cascade. x: [..., N], N % decim == 0."""
    hb_s, y = cascade_apply(plan.halfband_taps, state.hb, x)
    fir_s = state.fir
    if plan.final_taps is not None:
        fir_s, y = fir_apply(plan.final_taps, fir_s, y, decim=plan.final_decim)
    return DecimPlanState(hb=hb_s, fir=fir_s), y


def plan_response(plan: DecimPlan, nfreq: int = 4096) -> tuple:
    """(freqs at the input rate on [0, 0.5], |H| of the full cascade): stage
    i's response at f/rate_i, the composite response before any aliasing."""
    f = np.linspace(0.0, 0.5, nfreq)
    h_tot = np.ones(nfreq, np.complex128)
    rate = 1.0
    for h in plan.halfband_taps:
        hh = np.asarray(h, np.float64)
        z = np.exp(-2j * np.pi * np.outer(f / rate, np.arange(hh.size)))
        h_tot *= z @ hh
        rate /= 2.0
    if plan.final_taps is not None:
        hh = np.asarray(plan.final_taps, np.float64)
        z = np.exp(-2j * np.pi * np.outer(f / rate, np.arange(hh.size)))
        h_tot *= z @ hh
    return f, np.abs(h_tot)
