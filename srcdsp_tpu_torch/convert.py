"""Carry parameters and streaming state between the JAX package and this one.

For this DSP system the "weights" are the taps, the tuning words, the code
descriptions (LDPC, QC, turbo, convolutional, RS, BCH, polar, Golay, the
GF(2) machines and CRCs), the filter designs (IIR, decimation plan, DDC,
AGC, AFC), the OFDM and SC-FDE specs, the CSS, DSSS, FHSS, MLSE, frame-sync
and analog receivers' parameters, the protocol receivers' operators (the GPS
all-shifts matrix, the APT and SSTV lowpass taps), and the carried streaming state (the
GF(2) / CRC register, the convolutional interleaver's delay lines, the
tracking loops', the trackers', the OOK, DQPSK, equalizer, frame-sync and
analog chains' included), and the ops tier's designs and accumulators (the
FRESH filter, the DPD coefficients and history, the covariance and moment
sums). The JAX
objects are read through their attributes and ``np.asarray`` (no JAX import
here), so a stream started by the JAX package continues here with no seam;
`fsk_state_to_numpy` gives back plain arrays from which the JAX ``FskState``
is rebuilt.
"""

from __future__ import annotations

import numpy as np
import torch

from srcdsp_tpu_torch import bch as tbch
from srcdsp_tpu_torch import rs as trs
from srcdsp_tpu_torch.chains import analog as ana
from srcdsp_tpu_torch.chains.apt import AptParams
from srcdsp_tpu_torch.chains.channelizer import ChannelizerState
from srcdsp_tpu_torch.chains.css import CssParams
from srcdsp_tpu_torch.chains.dqpsk import DqpskState
from srcdsp_tpu_torch.chains.dsss import DsssParams
from srcdsp_tpu_torch.chains.equalizer import DfeState, EqState, RlsState
from srcdsp_tpu_torch.chains.fhss import FhssParams
from srcdsp_tpu_torch.chains.framesync import FrameSyncParams, FrameSyncState
from srcdsp_tpu_torch.chains.mlse import MlseTrellis
from srcdsp_tpu_torch.chains import tracking as ttr
from srcdsp_tpu_torch.chains import tracking_planes as ttp
from srcdsp_tpu_torch.chains.fsk import FskParams, FskState
from srcdsp_tpu_torch.chains.gps import GpsAcq
from srcdsp_tpu_torch.chains.ofdm import OfdmSpec
from srcdsp_tpu_torch.chains.ook import OokState
from srcdsp_tpu_torch.chains.psk import PskParams, PskState
from srcdsp_tpu_torch.chains.scfde import ScfdeSpec
from srcdsp_tpu_torch.chains.sstv import SstvParams
from srcdsp_tpu_torch.chains.sync import TimingState
from srcdsp_tpu_torch.chains.sync_loop import CostasState, GardnerFreeState, GardnerState
from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.fec import ConvCode
from srcdsp_tpu_torch.gf2 import CrcSpec, Gf2Machine
from srcdsp_tpu_torch.golay import Golay
from srcdsp_tpu_torch.interleave import ConvInterleaverState
from srcdsp_tpu_torch.kernels.fftconv_pallas import FftConvKernel, FftConvStream
from srcdsp_tpu_torch.kernels.ldpc_pallas import EdgePlan, QcPlan
from srcdsp_tpu_torch.array import CovState
from srcdsp_tpu_torch.ldpc import LdpcCode
from srcdsp_tpu_torch.ops.afc import AfcParams, AfcState
from srcdsp_tpu_torch.ops.agc import AgcParams
from srcdsp_tpu_torch.ops.cic import CicState
from srcdsp_tpu_torch.ops.ddc import DdcParams, DdcState
from srcdsp_tpu_torch.ops.dpd import DpdParams, DpdState
from srcdsp_tpu_torch.ops.decimplan import DecimPlan, DecimPlanState
from srcdsp_tpu_torch.ops.farrow import FarrowState
from srcdsp_tpu_torch.ops.fftconv import FftConvState
from srcdsp_tpu_torch.ops.fir import FirState
from srcdsp_tpu_torch.ops.fresh import FreshBranch, FreshFilter
from srcdsp_tpu_torch.ops.halfband import HalfbandState
from srcdsp_tpu_torch.ops.iir import IirParams, IirState
from srcdsp_tpu_torch.ops.impairments import MomentState
from srcdsp_tpu_torch.ops.nco import NcoState, word_tensor
from srcdsp_tpu_torch.ops.resample import ResampleState
from srcdsp_tpu_torch.polar import PolarCode
from srcdsp_tpu_torch.turbo import RscCode, TurboCode


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


def psk_params_from(p, device=None) -> PskParams:
    """PskParams from any object with the JAX PskParams fields."""
    device = resolve(device)
    return PskParams(freq_word=word_tensor(np.asarray(p.freq_word, np.uint32), device),
                     taps=torch.as_tensor(np.array(p.taps, np.float32), device=device),
                     decim=int(p.decim), sps=int(p.sps), order=int(p.order))


def psk_state_from(s, device=None) -> PskState:
    """PskState from any object shaped like the JAX PskState (s.nco.phase u32,
    s.fir.tail, s.timing.acc, s.timing.last complex, s.cr_acc)."""
    device = resolve(device)

    def c(a):
        return torch.as_tensor(np.array(a, np.complex64), device=device)

    return PskState(nco=NcoState(phase=word_tensor(np.asarray(s.nco.phase, np.uint32), device)),
                    fir=FirState(tail=c(s.fir.tail)),
                    timing=TimingState(acc=c(s.timing.acc), last=c(s.timing.last)),
                    cr_acc=c(s.cr_acc))


def channelizer_state_from(s, device=None) -> ChannelizerState:
    """ChannelizerState from any object with a ``tail`` field (the JAX
    ChannelizerState, analysis or synthesis), complex64."""
    return ChannelizerState(tail=torch.as_tensor(np.array(s.tail, np.complex64),
                                                 device=resolve(device)))


def fftconv_state_from(s, device=None) -> FftConvState:
    """FftConvState from any object with a ``tail`` field (the JAX
    FftConvState: the last fft_size - hop input samples, complex64)."""
    return FftConvState(tail=torch.as_tensor(np.array(s.tail, np.complex64),
                                             device=resolve(device)))


def fftconv_stream_from(stream, kernel: FftConvKernel) -> FftConvStream:
    """The port's FftConvStream over `kernel` (built with the same taps and
    tiling), carrying on from any object with a ``hist`` field (the JAX
    FftConvStream: [C, 2, overlap] float32), so the next chunk joins with no
    seam."""
    hist = np.array(stream.hist, np.float32)
    want = (kernel.num_channels, 2, kernel.overlap)
    if hist.shape != want:
        raise ValueError(f"hist shape {hist.shape} != {want}")
    out = FftConvStream(kernel)
    out.hist = torch.as_tensor(hist, device=kernel.device)
    return out


def ldpc_code_from(c, device=None) -> LdpcCode:
    """LdpcCode from any object with the JAX LdpcCode fields (h, gp,
    col_perm arrays; n, k)."""
    device = resolve(device)
    return LdpcCode(h=torch.as_tensor(np.array(c.h, np.float32), device=device),
                    gp=torch.as_tensor(np.array(c.gp, np.float32), device=device),
                    col_perm=torch.as_tensor(np.array(c.col_perm, np.int64), device=device),
                    n=int(c.n), k=int(c.k))


def edge_plan_from(p) -> EdgePlan:
    """EdgePlan (host arrays) from any object with the JAX EdgePlan fields
    (its dense `perm` is not needed: the port gathers through col_src)."""
    return EdgePlan(row_valid=np.array(p.row_valid, np.float32),
                    col_src=np.array(p.col_src, np.int32), row_src=np.array(p.row_src, np.int32),
                    n=int(p.n), m=int(p.m), n_pad=int(p.n_pad), m_pad=int(p.m_pad),
                    dv=int(p.dv), dc=int(p.dc))


def qc_plan_from(p) -> QcPlan:
    """QcPlan from any object with the JAX QcPlan fields."""
    layers = tuple((tuple(int(c) for c in cols), tuple(int(s) for s in shifts))
                   for cols, shifts in p.layers)
    return QcPlan(layers=layers, z=int(p.z), nb=int(p.nb), n_blocks=int(p.n_blocks))


def rsc_code_from(c) -> RscCode:
    """RscCode (host tables) from any object with the JAX RscCode fields."""
    return RscCode(k=int(c.k), fb=int(c.fb), g=int(c.g),
                   **{f: np.array(getattr(c, f), np.int32)
                      for f in ("next_state", "parity", "tail_bit", "prev_state", "prev_parity")})


def turbo_code_from(tc) -> TurboCode:
    """TurboCode from any object with the JAX TurboCode fields (rsc, perm)."""
    return TurboCode(rsc=rsc_code_from(tc.rsc), perm=np.array(tc.perm, np.int64))


# ---------- the decimation tier and the IIR family ----------

def _t(a, device, dtype=None) -> torch.Tensor:
    """A JAX value as a tensor on `device`, keeping its numpy dtype unless
    one is given."""
    return torch.as_tensor(np.array(a, dtype), device=device)


def iir_params_from(p, device=None) -> IirParams:
    """IirParams from any object with the JAX IirParams fields (al, f, g, h
    float32; block, order)."""
    device = resolve(device)
    return IirParams(**{f: _t(getattr(p, f), device, np.float32) for f in ("al", "f", "g", "h")},
                     block=int(p.block), order=int(p.order))


def iir_state_from(s, device=None) -> IirState:
    """IirState from any object with an ``s`` field (dtype kept)."""
    return IirState(s=_t(s.s, resolve(device)))


def decim_plan_from(plan) -> DecimPlan:
    """DecimPlan (host arrays) from any object with the JAX DecimPlan fields."""
    final = None if plan.final_taps is None else np.array(plan.final_taps, np.float32)
    return DecimPlan(halfband_taps=tuple(np.array(h, np.float64) for h in plan.halfband_taps),
                     final_taps=final, final_decim=int(plan.final_decim),
                     decim=int(plan.decim), passband=float(plan.passband),
                     atten_db=float(plan.atten_db), macs_per_input=float(plan.macs_per_input))


def ddc_params_from(p) -> DdcParams:
    """DdcParams (host values) from any object with the JAX DdcParams fields."""
    return DdcParams(freq_word=np.uint32(np.asarray(p.freq_word, np.uint32)),
                     plan=decim_plan_from(p.plan), decim=int(p.decim))


def agc_params_from(p, device=None) -> AgcParams:
    """AgcParams from any object with the JAX AgcParams fields."""
    return AgcParams(smoother=iir_params_from(p.smoother, device), target=float(p.target),
                     floor=float(p.floor))


def afc_params_from(p, device=None) -> AfcParams:
    """AfcParams from any object with the JAX AfcParams fields."""
    device = resolve(device)
    return AfcParams(upper_taps=_t(p.upper_taps, device, np.complex64),
                     lower_taps=_t(p.lower_taps, device, np.complex64), bw=float(p.bw),
                     gain=float(p.gain))


def cic_state_from(s, device=None) -> CicState:
    """CicState from any object with ``integ`` and ``combs`` (int32 or
    float32, kept)."""
    device = resolve(device)
    return CicState(integ=_t(s.integ, device), combs=_t(s.combs, device))


def halfband_state_from(s, device=None) -> HalfbandState:
    """HalfbandState from any object shaped like the JAX one (s.even.tail,
    s.odd)."""
    device = resolve(device)
    return HalfbandState(even=FirState(tail=_t(s.even.tail, device)), odd=_t(s.odd, device))


def decim_plan_state_from(s, device=None) -> DecimPlanState:
    """DecimPlanState from any object shaped like the JAX one (s.hb, s.fir)."""
    device = resolve(device)
    return DecimPlanState(hb=tuple(halfband_state_from(h, device) for h in s.hb),
                          fir=None if s.fir is None else FirState(tail=_t(s.fir.tail, device)))


def ddc_state_from(s, device=None) -> DdcState:
    """DdcState from any object shaped like the JAX one (s.nco.phase u32,
    s.plan)."""
    device = resolve(device)
    return DdcState(nco=NcoState(phase=word_tensor(np.asarray(s.nco.phase, np.uint32), device)),
                    plan=decim_plan_state_from(s.plan, device))


def farrow_state_from(s, device=None) -> FarrowState:
    """FarrowState from any object with ``tail`` and ``p`` (int32) fields."""
    device = resolve(device)
    return FarrowState(tail=_t(s.tail, device), p=_t(s.p, device, np.int32))


def afc_state_from(s, device=None) -> AfcState:
    """AfcState from any object shaped like the JAX one (s.freq f32,
    s.nco.phase u32, s.up.tail, s.lo.tail)."""
    device = resolve(device)
    return AfcState(freq=_t(s.freq, device, np.float32),
                    nco=NcoState(phase=word_tensor(np.asarray(s.nco.phase, np.uint32), device)),
                    up=FirState(tail=_t(s.up.tail, device)),
                    lo=FirState(tail=_t(s.lo.tail, device)))


# ---------- the classical FEC tier ----------

def conv_code_from(c) -> ConvCode:
    """ConvCode (host tables) from any object with the JAX ConvCode fields."""
    return ConvCode(k=int(c.k), n=int(c.n), gens=tuple(int(g) for g in c.gens),
                    taps=np.array(c.taps, np.float32), exp_pm1=np.array(c.exp_pm1, np.float32),
                    prev=np.array(c.prev, np.int32), prev_edge=np.array(c.prev_edge, np.int32))


def _code_from(c, cls, float_keys, device, host_keys=()):
    """`cls` from the same-named fields of `c`: ints kept, arrays moved."""
    fields = {f: getattr(c, f) for f in cls._fields}
    return trs.code_tensors({f: v if isinstance(v, int) else np.asarray(v) for f, v in fields.items()},
                            cls, float_keys, device, host_keys)


def rs_code_from(c, device=None) -> trs.RsCode:
    """RsCode (tables on `device`) from any object with the JAX RsCode fields."""
    return _code_from(c, trs.RsCode, ("enc_bits", "syn_bits"), device)


def bch_code_from(c, device=None) -> tbch.BchCode:
    """BchCode (tables on `device`, the generator on the host) from any object
    with the JAX BchCode fields."""
    return _code_from(c, tbch.BchCode, ("enc_bits", "syn_bits"), device, host_keys=("gen",))


def polar_code_from(c) -> PolarCode:
    """PolarCode (host arrays) from any object with the JAX PolarCode fields."""
    return PolarCode(n=int(c.n), k=int(c.k), frozen=np.array(c.frozen, bool),
                     data_pos=np.array(c.data_pos, np.int64))


def golay_from(c) -> Golay:
    """Golay (host tables) from any object with the JAX Golay fields."""
    return Golay(g=np.array(c.g), h=np.array(c.h), table=np.array(c.table, np.int8),
                 correctable=np.array(c.correctable, bool))


def gf2_machine_from(m) -> Gf2Machine:
    """Gf2Machine from any object with A, B, C, D and a block length (the JAX
    Gf2Machine's a, b, c, d, block)."""
    return Gf2Machine(np.array(m.a), np.array(m.b), np.array(m.c), int(m.d), int(m.block))


def crc_spec_from(spec) -> CrcSpec:
    """CrcSpec from any object with the JAX CrcSpec fields."""
    return CrcSpec(machine=gf2_machine_from(spec.machine), width=int(spec.width),
                   init=int(spec.init), xorout=int(spec.xorout), reflect=bool(spec.reflect))


def gf2_state_from(s, device=None) -> torch.Tensor:
    """A GF(2) machine's register [..., p] (a CRC's too) from the JAX one,
    float32."""
    return _t(s, resolve(device), np.float32)


def gf2_state_to_numpy(s: torch.Tensor) -> np.ndarray:
    """The register as a float32 numpy array (the JAX state's layout)."""
    return s.detach().cpu().numpy().astype(np.float32)



def conv_interleaver_state_from(s, device=None) -> ConvInterleaverState:
    """ConvInterleaverState (delay lines on `device`, dtypes kept) from any
    object with a ``lines`` tuple (the JAX interleaver or deinterleaver state)."""
    device = resolve(device)
    return ConvInterleaverState(lines=tuple(_t(line, device) for line in s.lines))


def conv_interleaver_state_to_numpy(s: ConvInterleaverState) -> tuple:
    """The delay lines as a tuple of numpy arrays."""
    return tuple(line.detach().cpu().numpy() for line in s.lines)


# ---------- the synchronization and block-equalizer tier ----------

def _f32(a, device) -> torch.Tensor:
    return _t(a, device, np.float32)


def _c64(a, device) -> torch.Tensor:
    return _t(a, device, np.complex64)


def _word(a, device) -> torch.Tensor:
    return word_tensor(np.asarray(a, np.uint32), device)


def gardner_state_from(s, device=None) -> GardnerState:
    """GardnerState from any object with ``tau`` and ``freq`` (float32)."""
    device = resolve(device)
    return GardnerState(tau=_f32(s.tau, device), freq=_f32(s.freq, device))


def gardner_free_state_from(s, device=None) -> GardnerFreeState:
    """GardnerFreeState from any object with ``pos``, ``freq`` and the
    complex ``prev``."""
    device = resolve(device)
    return GardnerFreeState(pos=_f32(s.pos, device), freq=_f32(s.freq, device),
                            prev=_c64(s.prev, device))


def costas_state_from(s, device=None) -> CostasState:
    """CostasState from any object with ``phase`` and ``freq`` (float32)."""
    device = resolve(device)
    return CostasState(phase=_f32(s.phase, device), freq=_f32(s.freq, device))


def _gardner_free_planes_from(s, device) -> ttp.GardnerFreePlanesState:
    return ttp.GardnerFreePlanesState(pos=_f32(s.pos, device), freq=_f32(s.freq, device),
                                      prev_r=_f32(s.prev_r, device),
                                      prev_i=_f32(s.prev_i, device))


def psk_track_state_from(s, device=None) -> ttr.PskTrackState:
    """PskTrackState from the JAX one (s.nco.phase u32, s.fir.tail, s.tail,
    s.gardner, s.costas)."""
    device = resolve(device)
    return ttr.PskTrackState(nco=NcoState(phase=_word(s.nco.phase, device)),
                             fir=FirState(tail=_c64(s.fir.tail, device)),
                             tail=_c64(s.tail, device),
                             gardner=gardner_state_from(s.gardner, device),
                             costas=costas_state_from(s.costas, device))


def fsk_track_state_from(s, device=None) -> ttr.FskTrackState:
    """FskTrackState from the JAX one (s.disc_last and s.tail complex)."""
    device = resolve(device)
    return ttr.FskTrackState(nco=NcoState(phase=_word(s.nco.phase, device)),
                             fir=FirState(tail=_c64(s.fir.tail, device)),
                             disc_last=_c64(s.disc_last, device), tail=_c64(s.tail, device),
                             gardner=gardner_state_from(s.gardner, device))


def psk_track_ragged_state_from(s, device=None) -> ttr.PskTrackRaggedState:
    """PskTrackRaggedState from the JAX one (a free-running Gardner state)."""
    device = resolve(device)
    return ttr.PskTrackRaggedState(nco=NcoState(phase=_word(s.nco.phase, device)),
                                   fir=FirState(tail=_c64(s.fir.tail, device)),
                                   tail=_c64(s.tail, device),
                                   gardner=gardner_free_state_from(s.gardner, device),
                                   costas=costas_state_from(s.costas, device))


def fsk_track_ragged_state_from(s, device=None) -> ttr.FskTrackRaggedState:
    """FskTrackRaggedState from the JAX one."""
    device = resolve(device)
    return ttr.FskTrackRaggedState(nco=NcoState(phase=_word(s.nco.phase, device)),
                                   fir=FirState(tail=_c64(s.fir.tail, device)),
                                   disc_last=_c64(s.disc_last, device),
                                   tail=_c64(s.tail, device),
                                   gardner=gardner_free_state_from(s.gardner, device))


def psk_track_planes_state_from(s, device=None) -> ttp.PskTrackPlanesState:
    """PskTrackPlanesState from the JAX one (s.word [C, 1] u32, s.hist,
    s.tail_r, s.tail_i, s.gardner, s.costas)."""
    device = resolve(device)
    return ttp.PskTrackPlanesState(word=_word(s.word, device), hist=_f32(s.hist, device),
                                   tail_r=_f32(s.tail_r, device), tail_i=_f32(s.tail_i, device),
                                   gardner=gardner_state_from(s.gardner, device),
                                   costas=costas_state_from(s.costas, device))


def fsk_track_planes_state_from(s, device=None) -> ttp.FskTrackPlanesState:
    """FskTrackPlanesState from the JAX one."""
    device = resolve(device)
    return ttp.FskTrackPlanesState(word=_word(s.word, device), hist=_f32(s.hist, device),
                                   disc_r=_f32(s.disc_r, device), disc_i=_f32(s.disc_i, device),
                                   tail=_f32(s.tail, device),
                                   gardner=gardner_state_from(s.gardner, device))


def psk_track_ragged_planes_state_from(s, device=None) -> ttp.PskTrackRaggedPlanesState:
    """PskTrackRaggedPlanesState from the JAX one."""
    device = resolve(device)
    return ttp.PskTrackRaggedPlanesState(
        word=_word(s.word, device), hist=_f32(s.hist, device), tail_r=_f32(s.tail_r, device),
        tail_i=_f32(s.tail_i, device), gardner=_gardner_free_planes_from(s.gardner, device),
        costas=costas_state_from(s.costas, device))


def fsk_track_ragged_planes_state_from(s, device=None) -> ttp.FskTrackRaggedPlanesState:
    """FskTrackRaggedPlanesState from the JAX one."""
    device = resolve(device)
    return ttp.FskTrackRaggedPlanesState(
        word=_word(s.word, device), hist=_f32(s.hist, device), disc_r=_f32(s.disc_r, device),
        disc_i=_f32(s.disc_i, device), tail=_f32(s.tail, device),
        gardner=_gardner_free_planes_from(s.gardner, device))


def ook_state_from(s, device=None) -> OokState:
    """OokState from the JAX one (s.mf_tail, s.timing.acc complex,
    s.timing.last float32, s.phase and the cluster sums)."""
    device = resolve(device)
    return OokState(mf_tail=_f32(s.mf_tail, device),
                    timing=TimingState(acc=_c64(s.timing.acc, device),
                                       last=_f32(s.timing.last, device)),
                    phase=_f32(s.phase, device), lo_sum=_f32(s.lo_sum, device),
                    lo_n=_f32(s.lo_n, device), hi_sum=_f32(s.hi_sum, device),
                    hi_n=_f32(s.hi_n, device))


def ofdm_spec_from(spec) -> OfdmSpec:
    """OfdmSpec (host fields) from any object with the JAX OfdmSpec fields."""
    return OfdmSpec(nfft=int(spec.nfft), cp=int(spec.cp),
                    active=np.array(spec.active, np.int64), order=int(spec.order))


def scfde_spec_from(spec, device=None) -> ScfdeSpec:
    """ScfdeSpec (pilot on `device`) from any object with the JAX ScfdeSpec
    fields."""
    return ScfdeSpec(n=int(spec.n), cp=int(spec.cp), pilot=_c64(spec.pilot, resolve(device)))


# ---------- the CSS modem and the rest of the plane-tier chains ----------

def css_params_from(p) -> CssParams:
    """CssParams (host numpy chirps) from any object with the JAX CssParams
    fields."""
    return CssParams(sf=int(p.sf), n=int(p.n), cr=int(p.cr), n_up=int(p.n_up),
                     sync1=int(p.sync1), sync2=int(p.sync2),
                     upchirp=np.array(p.upchirp, np.complex64),
                     downchirp=np.array(p.downchirp, np.complex64))


def dsss_params_from(p, device=None) -> DsssParams:
    """DsssParams (chips and shift matrix on `device`) from the JAX one."""
    device = resolve(device)
    return DsssParams(chips=_f32(p.chips, device), shifts=_f32(p.shifts, device), sf=int(p.sf))


def fhss_params_from(p) -> FhssParams:
    """FhssParams (host tables) from the JAX one."""
    return FhssParams(freqs=np.array(p.freqs, np.float64), seq=np.array(p.seq, np.int64),
                      hop_len=int(p.hop_len))


def mlse_trellis_from(t) -> MlseTrellis:
    """MlseTrellis (host tables) from the JAX one."""
    return MlseTrellis(points=np.array(t.points, np.complex64), h=np.array(t.h, np.complex64),
                       expected=np.array(t.expected, np.complex64), order=int(t.order),
                       mem=int(t.mem))


def eq_state_from(s, device=None) -> EqState:
    """EqState from any object with complex ``w`` and ``tail``."""
    device = resolve(device)
    return EqState(w=_c64(s.w, device), tail=_c64(s.tail, device))


def rls_state_from(s, device=None) -> RlsState:
    """RlsState from any object with complex ``w``, ``p`` and ``tail``."""
    device = resolve(device)
    return RlsState(w=_c64(s.w, device), p=_c64(s.p, device), tail=_c64(s.tail, device))


def dfe_state_from(s, device=None) -> DfeState:
    """DfeState from any object with complex ``ff``, ``fb``, ``tail`` and
    ``past``."""
    device = resolve(device)
    return DfeState(ff=_c64(s.ff, device), fb=_c64(s.fb, device), tail=_c64(s.tail, device),
                    past=_c64(s.past, device))


def dqpsk_state_from(s, device=None) -> DqpskState:
    """DqpskState from the JAX one (s.nco.phase u32, s.fir.tail, s.timing.acc
    and s.timing.last complex, s.prev)."""
    device = resolve(device)
    return DqpskState(nco=NcoState(phase=_word(s.nco.phase, device)),
                      fir=FirState(tail=_c64(s.fir.tail, device)),
                      timing=TimingState(acc=_c64(s.timing.acc, device),
                                         last=_c64(s.timing.last, device)),
                      prev=_c64(s.prev, device))


def frame_sync_params_from(p, device=None) -> FrameSyncParams:
    """FrameSyncParams (taps on `device`) from the JAX one."""
    device = resolve(device)
    return FrameSyncParams(mf_taps=_c64(p.mf_taps, device), en_taps=_f32(p.en_taps, device),
                           pnorm=float(p.pnorm), threshold=float(p.threshold))


def frame_sync_state_from(s, device=None) -> FrameSyncState:
    """FrameSyncState from the JAX one (complex corr tail, float32 energy
    tail and prev2, int32 base)."""
    device = resolve(device)
    return FrameSyncState(corr=FirState(tail=_c64(s.corr.tail, device)),
                          energy=FirState(tail=_f32(s.energy.tail, device)),
                          prev2=_f32(s.prev2, device), base=_t(s.base, device, np.int32))


def _iir_or_none(p, device):
    return None if p is None else iir_params_from(p, device)


def _iir_state_or_none(s, device):
    return None if s is None else IirState(s=_f32(s.s, device))


def fm_params_from(p, device=None) -> ana.FmParams:
    """FmParams from the JAX one (word, taps, de-emphasis IIR on `device`)."""
    device = resolve(device)
    return ana.FmParams(freq_word=_word(p.freq_word, device), chan_taps=_f32(p.chan_taps, device),
                        audio_taps=_f32(p.audio_taps, device),
                        deemph=_iir_or_none(p.deemph, device), decim=int(p.decim),
                        dev=float(p.dev), audio_decim=int(p.audio_decim))


def fm_state_from(s, device=None) -> ana.FmState:
    """FmState from the JAX one."""
    device = resolve(device)
    return ana.FmState(nco=NcoState(phase=_word(s.nco.phase, device)),
                       chan=FirState(tail=_c64(s.chan.tail, device)),
                       disc_last=_c64(s.disc_last, device),
                       audio=FirState(tail=_c64(s.audio.tail, device)),
                       deemph=_iir_state_or_none(s.deemph, device))


def am_params_from(p, device=None) -> ana.AmParams:
    """AmParams from the JAX one."""
    device = resolve(device)
    return ana.AmParams(freq_word=_word(p.freq_word, device), chan_taps=_f32(p.chan_taps, device),
                        audio_taps=_f32(p.audio_taps, device),
                        dcblock=iir_params_from(p.dcblock, device), decim=int(p.decim),
                        audio_decim=int(p.audio_decim))


def am_state_from(s, device=None) -> ana.AmState:
    """AmState from the JAX one (the DC blocker's state float32)."""
    device = resolve(device)
    return ana.AmState(nco=NcoState(phase=_word(s.nco.phase, device)),
                       chan=FirState(tail=_c64(s.chan.tail, device)),
                       dc=IirState(s=_f32(s.dc.s, device)),
                       audio=FirState(tail=_c64(s.audio.tail, device)))


def ssb_params_from(p, device=None) -> ana.SsbParams:
    """SsbParams from the JAX one (complex taps)."""
    device = resolve(device)
    return ana.SsbParams(freq_word=_word(p.freq_word, device), chan_taps=_c64(p.chan_taps, device),
                         decim=int(p.decim))


def ssb_state_from(s, device=None) -> ana.SsbState:
    """SsbState from the JAX one."""
    device = resolve(device)
    return ana.SsbState(nco=NcoState(phase=_word(s.nco.phase, device)),
                        chan=FirState(tail=_c64(s.chan.tail, device)))


def stereo_params_from(p, device=None) -> ana.StereoParams:
    """StereoParams from the JAX one."""
    device = resolve(device)
    return ana.StereoParams(pilot_taps=_c64(p.pilot_taps, device),
                            delay_taps=_f32(p.delay_taps, device),
                            audio_taps=_f32(p.audio_taps, device), audio_decim=int(p.audio_decim))


def stereo_state_from(s, device=None) -> ana.StereoState:
    """StereoState from the JAX one (four complex FIR tails)."""
    device = resolve(device)
    return ana.StereoState(*(FirState(tail=_c64(f.tail, device))
                             for f in (s.pilot, s.delay, s.mono, s.lr)))


def fm_stereo_rx_params_from(p, device=None) -> ana.FmStereoRxParams:
    """FmStereoRxParams from the JAX one."""
    device = resolve(device)
    return ana.FmStereoRxParams(freq_word=_word(p.freq_word, device),
                                chan_taps=_f32(p.chan_taps, device),
                                stereo=stereo_params_from(p.stereo, device),
                                deemph=_iir_or_none(p.deemph, device), decim=int(p.decim),
                                dev=float(p.dev))


def fm_stereo_rx_state_from(s, device=None) -> ana.FmStereoRxState:
    """FmStereoRxState from the JAX one."""
    device = resolve(device)
    return ana.FmStereoRxState(nco=NcoState(phase=_word(s.nco.phase, device)),
                               chan=FirState(tail=_c64(s.chan.tail, device)),
                               disc_last=_c64(s.disc_last, device),
                               stereo=stereo_state_from(s.stereo, device),
                               deemph=_iir_state_or_none(s.deemph, device))


# ---------- the ops tier ----------

def fresh_filter_from(f, device=None) -> FreshFilter:
    """FreshFilter from the JAX one: its weights, and its branches as the
    port's FreshBranch (alpha, conj)."""
    return FreshFilter(weights=_c64(f.weights, resolve(device)),
                       branches=tuple(FreshBranch(float(b.alpha), bool(b.conj))
                                      for b in f.branches),
                       taps=int(f.taps), delay=int(f.delay))


def dpd_params_from(p, device=None) -> DpdParams:
    """DpdParams from the JAX one."""
    return DpdParams(order=int(p.order), memory=int(p.memory),
                     coeffs=_c64(p.coeffs, resolve(device)))


def dpd_state_from(s, device=None) -> DpdState:
    """DpdState (the carried input tail) from the JAX one."""
    return DpdState(history=_c64(s.history, resolve(device)))


def cov_state_from(s, device=None) -> CovState:
    """CovState (the unnormalized X X^H and the snapshot count) from the JAX
    one."""
    device = resolve(device)
    return CovState(acc=_c64(s.acc, device), count=_f32(s.count, device))


def moment_state_from(s, device=None) -> MomentState:
    """MomentState (the running sums of the impairment estimators) from the
    JAX one."""
    device = resolve(device)
    return MomentState(n=_f32(s.n, device), s1=_c64(s.s1, device), sii=_f32(s.sii, device),
                       sqq=_f32(s.sqq, device), siq=_f32(s.siq, device),
                       sm2=_f32(s.sm2, device), sm4=_f32(s.sm4, device))


def gps_acq_from_jax(acq, device=None) -> GpsAcq:
    """GpsAcq (the all-shifts matrix float32 on `device`) from any object with
    the JAX GpsAcq fields."""
    return GpsAcq(shifts_t=_t(acq.shifts_t, resolve(device), np.float32), n=int(acq.n),
                  sps=int(acq.sps), prn=int(acq.prn))


def apt_params_from_jax(p, device=None) -> AptParams:
    """AptParams (the host lowpass taps moved to `device`) from any object with
    the JAX AptParams fields."""
    return AptParams(fs=float(p.fs), sps=float(p.sps), lo=float(p.lo), hi=float(p.hi),
                     lp_taps=_t(p.lp_taps, resolve(device), np.float32))


def sstv_params_from_jax(p, device=None) -> SstvParams:
    """SstvParams (the host lowpass taps moved to `device`) from any object with
    the JAX SstvParams fields."""
    return SstvParams(fs=float(p.fs), width=int(p.width), height=int(p.height),
                      lp_taps=_t(p.lp_taps, resolve(device), np.float32))
