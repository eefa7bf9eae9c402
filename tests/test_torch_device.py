"""The port's entry points run on the card unless the caller asks for the CPU.

Every builder, kernel factory, stream class and state constructor maps
``device=None`` to the CUDA device (``srcdsp_tpu_torch.device.resolve``).
With no card (``torch.cuda.is_available`` patched to False here), such a call
raises; it never quietly builds the plain CPU version. Passing
``device="cpu"`` runs on the CPU, as every CPU test does.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from srcdsp_tpu_torch import cli, configs, convert
from srcdsp_tpu_torch import bch, gf2, interleave, ldpc, qcldpc, rs, turbo
from srcdsp_tpu_torch.chains import channelizer, fsk, modem, psk, qam, sync, tx
from srcdsp_tpu_torch.chains import ofdm, ofdm_modem, ofdm_planes, ook, scfde, scfde_planes
from srcdsp_tpu_torch.chains import sync_loop, tracking, tracking_planes
from srcdsp_tpu_torch.chains import (analog, blindscan, css, css_planes, dqpsk, dsss,
                                     equalizer, fhss, framesync)
from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.dist import channelize as dchan
from srcdsp_tpu_torch.dist import fused as dfused
from srcdsp_tpu_torch.dist import halo as dhalo
from srcdsp_tpu_torch.dist import mesh as dmesh
from srcdsp_tpu_torch.io import capture
from srcdsp_tpu_torch.kernels import bank_pallas, bcjr_pallas, fft_pallas, fftconv_pallas, ldpc_pallas
from srcdsp_tpu_torch.kernels import fsk_ctaps, fsk_fused, fsk_preframed, mixfir
from srcdsp_tpu_torch.kernels import ctaps_aligned, mixfir_ctaps, mixfir_preframed, mixfir_rows
from srcdsp_tpu_torch.kernels import halo_dma, halo_fused
from srcdsp_tpu_torch.kernels import resample_pallas, resample_preframed
from srcdsp_tpu_torch.ops import afc, agc, channelize_planes, cic, ddc, decimplan, farrow
from srcdsp_tpu_torch.ops import fft_planes, fftconv, fftconv_planes, fir, halfband, iir, nco
from srcdsp_tpu_torch.ops import planes, resample, spectrum
from srcdsp_tpu_torch import array, mimo
from srcdsp_tpu_torch.chains import (acars, adsb, ais, apt, ax25, ble, cw, dcf77, gps, navtex,
                                     pocsag, rds, rtty, same, sstv)
from srcdsp_tpu_torch.ops import accel, cfar, cyclo, dpd, fresh, fresh_planes, impairments, radar
from srcdsp_tpu_torch.ops.window import lowpass
from srcdsp_tpu_torch.testing import signals
from tests.torch_threads import one_torch_thread  # noqa: F401

TAPS = lowpass(64, 0.03)
WORDS = np.asarray([1 << 28, 3 << 27], np.uint32)


class _JaxLike:
    """Attribute bags shaped like the JAX FskParams / FskState / ResampleState."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _fsk_state():
    return _JaxLike(nco=_JaxLike(phase=np.uint32(0)), fir=_JaxLike(tail=np.zeros(63, np.complex64)),
                    disc_last=np.complex64(0), timing=_JaxLike(acc=np.complex64(0),
                                                               last=np.zeros(9, np.float32)))


def _halfband_state():
    return _JaxLike(even=_JaxLike(tail=np.zeros(5, np.complex64)), odd=np.zeros(3, np.complex64))


def _psk_state():
    return _JaxLike(nco=_JaxLike(phase=np.uint32(0)), fir=_JaxLike(tail=np.zeros(32, np.complex64)),
                    timing=_JaxLike(acc=np.complex64(0), last=np.zeros(5, np.complex64)),
                    cr_acc=np.complex64(0))


def _psk_p(**d):
    return psk.make_psk_params(0.17, 2, 4, **d)


def _fsk_p(**d):
    return fsk.make_fsk_params(0.11, 64, 0.03, 2, 8, 0.05, **d)


# the tracker states, built on the CPU: the converters read any object with
# the JAX states' fields, the port's own included
TRACK_STATES = {
    "psk_track": tracking.psk_track_init(_psk_p(device="cpu"), (2,)),
    "fsk_track": tracking.fsk_track_init(_fsk_p(device="cpu"), (2,)),
    "psk_track_ragged": tracking.psk_track_ragged_init(_psk_p(device="cpu"), (2,)),
    "fsk_track_ragged": tracking.fsk_track_ragged_init(_fsk_p(device="cpu"), (2,)),
    "psk_track_planes": tracking_planes.psk_track_planes_init(_psk_p(device="cpu"), 2),
    "fsk_track_planes": tracking_planes.fsk_track_planes_init(_fsk_p(device="cpu"), 2),
    "psk_track_ragged_planes": tracking_planes.psk_track_ragged_planes_init(
        _psk_p(device="cpu"), 2),
    "fsk_track_ragged_planes": tracking_planes.fsk_track_ragged_planes_init(
        _fsk_p(device="cpu"), 2),
}
OFDM_SPEC = ofdm.make_ofdm_spec()
CSS_P = css.make_css_params(sf=6)
CSS_X = np.ones(64 * 24, np.complex64)
FHSS_P = fhss.make_fhss_params([-0.2, 0.1, 0.3], [0, 2, 1], 64)
PRE = np.exp(0.5j * np.arange(16)).astype(np.complex64)
# name -> (factory(**d) -> params, init(params, channel_shape))
ANALOG = {
    "fm": (lambda **d: analog.make_fm_params(0.1, 4, 0.08, deemph_tau=20.0, **d), analog.fm_init),
    "am": (lambda **d: analog.make_am_params(0.1, 4, **d), analog.am_init),
    "ssb": (lambda **d: analog.make_ssb_params(0.1, 2, 0.04, **d), analog.ssb_init),
    "stereo": (lambda **d: analog.make_fm_stereo_params(0.08, 0.06, 4, **d),
               analog.fm_stereo_init),
    "fm_stereo_rx": (lambda **d: analog.make_fm_stereo_rx(0.07, 4, 0.08, 0.08, deemph_tau=8.0,
                                                          **d), analog.fm_stereo_rx_init),
}
SCFDE_SPEC = scfde.make_scfde_spec(64, 16, device="cpu")

PROTO = channelizer.design_prototype(8, 4)
DDC = ddc.make_ddc(0.21, 0.0155)
HB = halfband.design_halfband(11)
IIR_P = iir.make_iir_params(*iir.dc_block_coeffs(), device="cpu")
AFC_P = afc.make_afc(0.125, device="cpu")
AGC_P = agc.make_agc_params(device="cpu")
H120 = ldpc.make_regular_ldpc(120, 3, 6, seed=1)
QC_BASE = qcldpc.make_dual_diagonal_base(4, 12, 16, seed=1)
QC_CODE = qcldpc.make_qc_ldpc(QC_BASE, 16, device="cpu")


def _on_mesh(run, device=None):
    """run(mesh) on a 2-shard time mesh: the card's by default (make_mesh
    raises without one), else `device` repeated."""
    return run(dmesh.make_mesh(time=2, devices=None if device is None else [device] * 2))


def _cshards(mesh, n=1024):
    return dmesh.shard(torch.zeros(n, dtype=torch.complex64), mesh)


def _pshards(mesh, n=1024):
    return dmesh.shard(torch.zeros((2, n)), mesh)


def _k20(mesh):
    return halo_fused.make_halo_fused_kernel(TAPS, 2, b_rows=2, device=mesh.devices[0][0])


def _cli(argv, device=None):
    """The CLI's main on a small capture in a fresh directory; `--device`
    only where the caller gives one (none = the card)."""
    import tempfile

    d = tempfile.mkdtemp()
    capture.write_capture(f"{d}/in.cf32", np.ones(512, np.complex64),
                          capture.CaptureMeta(fmt="cf32"))
    cli.main([a.replace("{dir}", d) for a in argv]
             + ([] if device is None else ["--device", str(device)]))


Z64 = np.zeros(64, np.complex64)
NOISE = np.random.default_rng(1).standard_normal(20800).astype(np.float32)
PW = np.ones((2, 64), np.float32)
FRESH_BR = (fresh.FreshBranch(0.0, False), fresh.FreshBranch(0.25, True))
FRESH_F = fresh.FreshFilter(weights=torch.zeros(8, dtype=torch.complex64), branches=FRESH_BR,
                            taps=4, delay=2)
LATTICE = mimo.make_ml_lattice(np.array([1.0, -1.0]), 2)
H22 = np.eye(2, dtype=np.complex64)


ENTRY_POINTS = {
    "make_mesh": lambda **d: _on_mesh(lambda m: m, **d),
    "fir_time_sharded": lambda **d: _on_mesh(
        lambda m: dhalo.fir_time_sharded(TAPS, _cshards(m), m), **d),
    "fir_time_sharded_stream": lambda **d: _on_mesh(
        lambda m: dhalo.fir_time_sharded_stream(TAPS, torch.zeros(63, dtype=torch.complex64),
                                                _cshards(m), m), **d),
    "channelize_time_sharded": lambda **d: _on_mesh(
        lambda m: dchan.channelize_time_sharded(PROTO, _cshards(m), 8, m), **d),
    "channelize_time_sharded_stream": lambda **d: _on_mesh(
        lambda m: dchan.channelize_time_sharded_stream(
            PROTO, torch.zeros(31, dtype=torch.complex64), _cshards(m), 8, m), **d),
    "channelize_os2_time_sharded": lambda **d: _on_mesh(
        lambda m: dchan.channelize_os2_time_sharded(PROTO, _cshards(m), 8, m), **d),
    "mix_fir_time_sharded": lambda **d: _on_mesh(
        lambda m: dfused.mix_fir_time_sharded(
            mixfir.make_mix_fir_kernel(TAPS, 2, out_tile=128, b_rows=2, device=m.devices[0][0]),
            0, 1 << 28, torch.zeros(2, 128), _pshards(m), m), **d),
    "fftconv_time_sharded": lambda **d: _on_mesh(
        lambda m: dfused.fftconv_time_sharded(
            fftconv_pallas.make_fftconv_kernel(TAPS, 2048, b_frames=1, device=m.devices[0][0]),
            torch.zeros(1, 2, 1024), dmesh.shard(torch.zeros(1, 2, 2048), m), m), **d),
    "halo_from_left_pallas": lambda **d: _on_mesh(
        lambda m: halo_dma.halo_from_left_pallas(_pshards(m), 16), **d),
    "make_halo_fused_kernel": lambda **d: halo_fused.make_halo_fused_kernel(TAPS, 2, **d),
    "mix_fir_halo_sharded": lambda **d: _on_mesh(
        lambda m: halo_fused.mix_fir_halo_sharded(_k20(m), 0, 1 << 28, torch.zeros(2, 128),
                                                  _pshards(m), m), **d),
    "build_config5_mesh": lambda **d: _on_mesh(
        lambda m: configs.build_config5(64, 8, mesh=m).step(*configs.build_config5(
            64, 8, mesh=m).example), **d),
    "make_ldpc_code": lambda **d: ldpc.make_ldpc_code(H120, **d),
    "make_qc_ldpc": lambda **d: qcldpc.make_qc_ldpc(QC_BASE, 16, **d),
    "ldpc_code_from": lambda **d: convert.ldpc_code_from(QC_CODE, **d),
    "make_ldpc_kernel": lambda **d: ldpc_pallas.make_ldpc_kernel(ldpc_pallas.plan_edges(H120), **d),
    "make_ldpc_decoder": lambda **d: ldpc_pallas.make_ldpc_decoder(
        QC_CODE, ldpc_pallas.plan_edges(QC_CODE.h.numpy()), **d),
    "make_qc_kernel": lambda **d: ldpc_pallas.make_qc_kernel(ldpc_pallas.plan_qc(QC_BASE, 16), **d),
    "make_qc_decoder": lambda **d: ldpc_pallas.make_qc_decoder(
        QC_CODE, ldpc_pallas.plan_qc(QC_BASE, 16), **d),
    "make_qc_decoder_t": lambda **d: ldpc_pallas.make_qc_decoder_t(
        QC_CODE, ldpc_pallas.plan_qc(QC_BASE, 16), **d),
    "make_bcjr_kernel": lambda **d: bcjr_pallas.make_bcjr_kernel(turbo.make_rsc(), 16, True, **d),
    "make_coherent_modem": lambda **d: modem.make_coherent_modem(
        TAPS, WORDS, 2, 16, QC_CODE, ldpc_pallas.plan_qc(QC_BASE, 16), nw=64, **d),
    "make_qam_params": lambda **d: qam.make_qam_params(0.1, 2, 4, **d),
    "qam_modulate": lambda **d: qam.qam_modulate(np.random.default_rng(0), 8, 16, **d),
    "make_linear_tx": lambda **d: tx.make_linear_tx(0.1, TAPS, 4, **d),
    "make_cpfsk_tx": lambda **d: tx.make_cpfsk_tx(0.1, 8, 0.03, **d),
    "make_gmsk_tx": lambda **d: tx.make_gmsk_tx(0.1, 8, **d),
    "build_coded_modem": lambda **d: configs.build_coded_modem(
        2, 4, iters=1, z=16, out_tile=128, b_rows=2, b_tile=8, **d),
    "build_coded_link": lambda **d: configs.build_coded_link(1, 2, iters=1, out_tile=128,
                                                             b_rows=2, **d),
    "build_ldpc": lambda **d: configs.build_ldpc("edges", batch=4, iters=1, **d),
    "build_turbo": lambda **d: configs.build_turbo(t=16, iters=1, batch=4, **d),
    "build_config1": lambda **d: configs.build_config1(1 << 12, **d),
    "build_config1_kernel": lambda **d: configs.build_config1(1 << 12, use_kernel=True, **d),
    "build_config1_serving": lambda **d: configs.build_config1_serving(1 << 15, "ctaps", **d),
    "build_config2": lambda **d: configs.build_config2(1 << 10, 2, **d),
    "build_config2_onchip": lambda **d: configs.build_config2_onchip(1 << 14, "fused", **d),
    "build_config3": lambda **d: configs.build_config3(1 << 13, 2, **d),
    "build_config3_onchip": lambda **d: configs.build_config3_onchip(49152, "fused", 1, **d),
    "build_fft": lambda **d: configs.build_fft(16, 256, "kernel", **d),
    "build_config4": lambda **d: configs.build_config4(64, 2, **d),
    "build_config5": lambda **d: configs.build_config5(64, 8, **d),
    "build_config5_onchip": lambda **d: configs.build_config5_onchip(256, "fused", 8, 128, **d),
    "build_config5_onchip_planes": lambda **d: configs.build_config5_onchip(256, "planes", 8,
                                                                          **d),
    "make_bank_kernel": lambda **d: bank_pallas.make_bank_kernel(PROTO, 8, **d),
    "make_bank_psk_kernel": lambda **d: bank_pallas.make_bank_psk_kernel(PROTO, 8, 4, **d),
    "make_channelize_planes": lambda **d: channelize_planes.make_channelize_planes(PROTO, 8, **d),
    "make_channelize_os2_planes": lambda **d: channelize_planes.make_channelize_os2_planes(
        PROTO, 8, **d),
    "make_synthesize_planes": lambda **d: channelize_planes.make_synthesize_planes(PROTO, 8, **d),
    "channelizer_init": lambda **d: channelizer.channelizer_init(PROTO, 8, (2,), **d),
    "synthesizer_init": lambda **d: channelizer.synthesizer_init(PROTO, 8, (2,), **d),
    "synthesizer_os2_init": lambda **d: channelizer.synthesizer_os2_init(PROTO, 8, (2,), **d),
    "make_psk_params": lambda **d: psk.make_psk_params(0.17, 2, 4, **d),
    "psk_params_from": lambda **d: convert.psk_params_from(
        _JaxLike(freq_word=np.uint32(5), taps=TAPS, decim=2, sps=4, order=4), **d),
    "psk_state_from": lambda **d: convert.psk_state_from(_psk_state(), **d),
    "psk_wideband": lambda **d: signals.psk_wideband(np.random.default_rng(0), 4, 16, **d),
    "channelizer_state_from": lambda **d: convert.channelizer_state_from(
        _JaxLike(tail=np.zeros(31, np.complex64)), **d),
    "make_fft_kernel": lambda **d: fft_pallas.make_fft_kernel(1024, **d),
    "make_fftconv_kernel": lambda **d: fftconv_pallas.make_fftconv_kernel(TAPS, 2048, **d),
    "make_fft_planes": lambda **d: fft_planes.make_fft_planes(1024, **d),
    "make_fftconv_planes": lambda **d: fftconv_planes.make_fftconv_planes(TAPS, 1024, **d),
    "make_freq_response": lambda **d: fftconv.make_freq_response(TAPS, 1024, **d),
    "fftconv_init": lambda **d: fftconv.fftconv_init(64, 1024, (2,), **d),
    "make_mix_fir_kernel": lambda **d: mixfir.make_mix_fir_kernel(TAPS, 2, **d),
    "make_ctaps_aligned_kernel": lambda **d: ctaps_aligned.make_ctaps_aligned_kernel(
        TAPS, 1 << 28, 2, **d),
    "make_mix_fir_rows_kernel": lambda **d: mixfir_rows.make_mix_fir_rows_kernel(TAPS, 2, **d),
    "ddc_init": lambda **d: ddc.ddc_init(DDC, (2,), **d),
    "decim_plan_init": lambda **d: decimplan.decim_plan_init(DDC.plan, (2,), **d),
    "halfband_init": lambda **d: halfband.halfband_init(HB, (2,), **d),
    "cascade_init": lambda **d: halfband.cascade_init([HB, HB], (2,), **d),
    "cic_decim_init": lambda **d: cic.cic_decim_init(4, 1, (2,), **d),
    "cic_interp_init": lambda **d: cic.cic_interp_init(4, 1, (2,), **d),
    "farrow_init": lambda **d: farrow.farrow_init((2,), **d),
    "make_iir_params": lambda **d: iir.make_iir_params(*iir.dc_block_coeffs(), **d),
    "make_sos_params": lambda **d: iir.make_sos_params(np.array([[1.0, 0, 0, 1, -0.5, 0]]), **d),
    "iir_init": lambda **d: iir.iir_init(IIR_P, (2,), **d),
    "sos_init": lambda **d: iir.sos_init((IIR_P, IIR_P), (2,), **d),
    "make_agc_params": lambda **d: agc.make_agc_params(**d),
    "agc_init": lambda **d: agc.agc_init(AGC_P, (2,), **d),
    "make_afc": lambda **d: afc.make_afc(0.125, **d),
    "afc_init": lambda **d: afc.afc_init(AFC_P, **d),
    "welch_stream_init": lambda **d: spectrum.welch_stream_init(64, 32, (2,), **d),
    "iir_params_from": lambda **d: convert.iir_params_from(IIR_P, **d),
    "iir_state_from": lambda **d: convert.iir_state_from(_JaxLike(s=np.zeros(1, np.complex64)),
                                                         **d),
    "agc_params_from": lambda **d: convert.agc_params_from(AGC_P, **d),
    "afc_params_from": lambda **d: convert.afc_params_from(AFC_P, **d),
    "cic_state_from": lambda **d: convert.cic_state_from(
        _JaxLike(integ=np.zeros(4, np.int32), combs=np.zeros((4, 1), np.int32)), **d),
    "halfband_state_from": lambda **d: convert.halfband_state_from(_halfband_state(), **d),
    "decim_plan_state_from": lambda **d: convert.decim_plan_state_from(
        _JaxLike(hb=(_halfband_state(),), fir=None), **d),
    "ddc_state_from": lambda **d: convert.ddc_state_from(
        _JaxLike(nco=_JaxLike(phase=np.uint32(7)),
                 plan=_JaxLike(hb=(), fir=_JaxLike(tail=np.zeros(8, np.complex64)))), **d),
    "farrow_state_from": lambda **d: convert.farrow_state_from(
        _JaxLike(tail=np.zeros(3, np.complex64), p=np.int32(-3)), **d),
    "afc_state_from": lambda **d: convert.afc_state_from(
        _JaxLike(freq=np.float32(0.01), nco=_JaxLike(phase=np.uint32(0)),
                 up=_JaxLike(tail=np.zeros(63, np.complex64)),
                 lo=_JaxLike(tail=np.zeros(63, np.complex64))), **d),
    "make_mix_fir_kernel_mc": lambda **d: mixfir.make_mix_fir_kernel_mc(TAPS, 2, 2, **d),
    "make_mix_fir_ctaps_kernel": lambda **d: mixfir_ctaps.make_mix_fir_ctaps_kernel(
        TAPS, 1 << 28, 2, **d),
    "make_ctaps_preframed_kernel": lambda **d: mixfir_preframed.make_ctaps_preframed_kernel(
        TAPS, 1 << 28, 2, **d),
    "make_frame_kernel": lambda **d: mixfir_preframed.make_frame_kernel(1024, 1152, **d),
    "make_fsk_mc_kernel": lambda **d: fsk_fused.make_fsk_mc_kernel(TAPS, 4, 2, 8, **d),
    "make_fsk_ctaps_kernel": lambda **d: fsk_ctaps.make_fsk_ctaps_kernel(TAPS, WORDS, 4, 8,
                                                                         **d),
    "FskCtapsStream": lambda **d: fsk_ctaps.FskCtapsStream(TAPS, WORDS, 4, 8, 2, **d),
    "make_fsk_preframed_kernel": lambda **d: fsk_preframed.make_fsk_preframed_kernel(
        TAPS, WORDS, 4, 8, **d),
    "make_mix_resample_kernel": lambda **d: resample_pallas.make_mix_resample_kernel(
        TAPS, 3, 4, out_tile=384, **d),
    "make_mix_resample_kernel_mc": lambda **d: resample_pallas.make_mix_resample_kernel_mc(
        TAPS, 3, 4, 2, out_tile=384, **d),
    "make_resample_preframed_kernel":
        lambda **d: resample_preframed.make_resample_preframed_kernel(
            TAPS, 1 << 28, 3, 4, out_tile=384, **d),
    "make_fsk_params": lambda **d: fsk.make_fsk_params(0.11, 64, 0.03, 4, 8, 0.05, **d),
    "timing_init": lambda **d: sync.timing_init(8, (2,), **d),
    "nco_init": lambda **d: nco.nco_init((2,), **d),
    "fir_init": lambda **d: fir.fir_init(64, (2,), **d),
    "resample_init": lambda **d: resample.resample_init(48, 3, (2,), **d),
    "nco_planes": lambda **d: planes.nco_planes(1, 2, 64, **d),
    "fsk_params_from": lambda **d: convert.fsk_params_from(
        _JaxLike(freq_word=np.uint32(5), taps=TAPS, decim=4, sps=8, dev=0.05,
                 timing_forget=0.5), **d),
    "fsk_state_from": lambda **d: convert.fsk_state_from(_fsk_state(), **d),
    "resample_state_from": lambda **d: convert.resample_state_from(
        _JaxLike(tail=np.zeros(16, np.complex64)), **d),
    "fftconv_state_from": lambda **d: convert.fftconv_state_from(
        _JaxLike(tail=np.zeros(961, np.complex64)), **d),
    "gf2_init": lambda **d: gf2.gf2_init(gf2.make_scrambler((4, 7), 7), 0x5D, **d),
    "crc_init": lambda **d: gf2.crc_init(gf2.make_crc(0x1021, 16, 0xFFFF), **d),
    "conv_interleave_init": lambda **d: interleave.conv_interleave_init(4, 3, (2,), **d),
    "conv_deinterleave_init": lambda **d: interleave.conv_deinterleave_init(4, 3, (2,), **d),
    "make_rs_code": lambda **d: rs.make_rs_code(15, 11, **d),
    "make_bch_code": lambda **d: bch.make_bch_code(4, 1, **d),
    "rs_code_from": lambda **d: convert.rs_code_from(rs.make_rs_code(15, 11, device="cpu"), **d),
    "bch_code_from": lambda **d: convert.bch_code_from(bch.make_bch_code(4, 1, device="cpu"), **d),
    "gf2_state_from": lambda **d: convert.gf2_state_from(np.ones(7, np.float32), **d),
    "conv_interleaver_state_from": lambda **d: convert.conv_interleaver_state_from(
        _JaxLike(lines=(np.zeros(0, np.float32), np.zeros(3, np.float32))), **d),
    "gardner_init": lambda **d: sync_loop.gardner_init((2,), **d),
    "gardner_free_init": lambda **d: sync_loop.gardner_free_init((2,), **d),
    "costas_init": lambda **d: sync_loop.costas_init((2,), **d),
    "gardner_free_init_planes": lambda **d: tracking_planes.gardner_free_init_planes((2,), **d),
    "psk_track_init": lambda **d: tracking.psk_track_init(_psk_p(**d), (2,)),
    "fsk_track_init": lambda **d: tracking.fsk_track_init(_fsk_p(**d), (2,)),
    "psk_track_ragged_init": lambda **d: tracking.psk_track_ragged_init(_psk_p(**d), (2,)),
    "fsk_track_ragged_init": lambda **d: tracking.fsk_track_ragged_init(_fsk_p(**d), (2,)),
    "psk_track_planes_init": lambda **d: tracking_planes.psk_track_planes_init(_psk_p(**d), 2),
    "fsk_track_planes_init": lambda **d: tracking_planes.fsk_track_planes_init(_fsk_p(**d), 2),
    "psk_track_ragged_planes_init": lambda **d: tracking_planes.psk_track_ragged_planes_init(
        _psk_p(**d), 2),
    "fsk_track_ragged_planes_init": lambda **d: tracking_planes.fsk_track_ragged_planes_init(
        _fsk_p(**d), 2),
    "ook_init": lambda **d: ook.ook_init(ook.make_ook_params(8), (2,), **d),
    "schmidl_cox_preamble": lambda **d: ofdm.schmidl_cox_preamble(
        OFDM_SPEC, np.random.default_rng(0), **d),
    "make_ofdm_rx_planes": lambda **d: ofdm_planes.make_ofdm_rx_planes(OFDM_SPEC, **d),
    "make_scfde_spec": lambda **d: scfde.make_scfde_spec(64, 16, **d),
    "make_scfde_rx_planes": lambda **d: scfde_planes.make_scfde_rx_planes(SCFDE_SPEC, **d),
    "make_ofdm_coded_modem": lambda **d: ofdm_modem.make_ofdm_coded_modem(
        OFDM_SPEC, QC_CODE, ldpc_pallas.plan_qc(QC_BASE, 16), num_channels=2, nw=64, **d),
    "gardner_state_from": lambda **d: convert.gardner_state_from(
        sync_loop.gardner_init((2,), device="cpu"), **d),
    "gardner_free_state_from": lambda **d: convert.gardner_free_state_from(
        sync_loop.gardner_free_init((2,), device="cpu"), **d),
    "costas_state_from": lambda **d: convert.costas_state_from(
        sync_loop.costas_init((2,), device="cpu"), **d),
    **{f"{k}_state_from": (lambda k: lambda **d: getattr(convert, f"{k}_state_from")(
        TRACK_STATES[k], **d))(k) for k in TRACK_STATES},
    "ook_state_from": lambda **d: convert.ook_state_from(
        ook.ook_init(ook.make_ook_params(8), (2,), device="cpu"), **d),
    "scfde_spec_from": lambda **d: convert.scfde_spec_from(SCFDE_SPEC, **d),
    # the CSS modem and the rest of the plane-tier chains
    "make_css_demod_planes": lambda **d: css_planes.make_css_demod_planes(CSS_P, **d),
    "make_css_demod_planes_fourstep": lambda **d: css_planes.make_css_demod_planes(
        CSS_P, direct=False, **d),
    "make_css_llr_planes": lambda **d: css_planes.make_css_llr_planes(CSS_P, **d),
    "css_sync": lambda **d: css.css_sync(CSS_P, CSS_X, **d),
    "css_receive": lambda **d: css.css_receive(CSS_P, CSS_X, 4, **d),
    "css_receive_stream": lambda **d: css.css_receive_stream(CSS_P, CSS_X, 4, **d),
    "css_decode_frames_soft_batch": lambda **d: css.css_decode_frames_soft_batch(
        CSS_P, np.ones((2, css.css_frame_nsym(CSS_P, 4), CSS_P.sf), np.float32), 4, **d),
    "fm_modulate": lambda **d: analog.fm_modulate(np.zeros(64), 0.02, **d),
    "am_modulate": lambda **d: analog.am_modulate(np.zeros(64), 0.5, **d),
    "blindscan_scan": lambda **d: blindscan.scan(np.ones(512, np.complex64), nfft=64, **d),
    "detect_css": lambda **d: blindscan.detect_css(CSS_X, sf_range=range(6, 8), **d),
    "fhss_acquire": lambda **d: fhss.fhss_acquire(FHSS_P, np.ones(1024, np.complex64), **d),
    "make_frame_sync_params": lambda **d: framesync.make_frame_sync_params(PRE, **d),
    "frame_sync_init": lambda **d: framesync.frame_sync_init(
        framesync.make_frame_sync_params(PRE, **d), (2,)),
    "make_dqpsk_params": lambda **d: dqpsk.make_dqpsk_params(0.1, 4, 8, **d),
    "dqpsk_init": lambda **d: dqpsk.dqpsk_init(dqpsk.make_dqpsk_params(0.1, 4, 8, **d), (2,)),
    "make_dsss_params": lambda **d: dsss.make_dsss_params(**d),
    "eq_init": lambda **d: equalizer.eq_init(7, channel_shape=(2,), **d),
    "rls_init": lambda **d: equalizer.rls_init(7, **d),
    "dfe_init": lambda **d: equalizer.dfe_init(5, 3, **d),
    **{f"make_{k}": (lambda k: lambda **d: ANALOG[k][0](**d))(k) for k in ANALOG},
    **{f"{k}_init": (lambda k: lambda **d: ANALOG[k][1](ANALOG[k][0](**d), (2,)))(k)
       for k in ANALOG},
    **{f"{k}_params_from": (lambda k: lambda **d: getattr(convert, f"{k}_params_from")(
        ANALOG[k][0](device="cpu"), **d))(k) for k in ANALOG},
    **{f"{k}_state_from": (lambda k: lambda **d: getattr(convert, f"{k}_state_from")(
        ANALOG[k][1](ANALOG[k][0](device="cpu"), (2,)), **d))(k) for k in ANALOG},
    "dsss_params_from": lambda **d: convert.dsss_params_from(
        dsss.make_dsss_params(device="cpu"), **d),
    "dqpsk_state_from": lambda **d: convert.dqpsk_state_from(
        dqpsk.dqpsk_init(dqpsk.make_dqpsk_params(0.1, 4, 8, device="cpu"), (2,)), **d),
    "frame_sync_params_from": lambda **d: convert.frame_sync_params_from(
        framesync.make_frame_sync_params(PRE, device="cpu"), **d),
    "frame_sync_state_from": lambda **d: convert.frame_sync_state_from(
        framesync.frame_sync_init(framesync.make_frame_sync_params(PRE, device="cpu")), **d),
    "eq_state_from": lambda **d: convert.eq_state_from(equalizer.eq_init(7, device="cpu"), **d),
    "rls_state_from": lambda **d: convert.rls_state_from(equalizer.rls_init(7, device="cpu"),
                                                         **d),
    "dfe_state_from": lambda **d: convert.dfe_state_from(equalizer.dfe_init(5, 3, device="cpu"),
                                                         **d),
    # the ops tier
    "ca_cfar": lambda **d: cfar.ca_cfar(PW, guard=1, train=4, **d),
    "go_cfar_split": lambda **d: cfar.go_cfar_split(PW, guard=1, train=4, **d),
    "moments_init": lambda **d: impairments.moments_init((2,), **d),
    "iq_imbalance_estimate": lambda **d: impairments.iq_imbalance_estimate(Z64 + 1, **d),
    "iq_imbalance_apply": lambda **d: impairments.iq_imbalance_apply(Z64, 1.1, 0.1, **d),
    "dc_offset": lambda **d: impairments.dc_offset(Z64, **d),
    "cfo_kay": lambda **d: impairments.cfo_kay(Z64 + 1, **d),
    "cfo_fft_peak": lambda **d: impairments.cfo_fft_peak(Z64 + 1, **d),
    "snr_m2m4": lambda **d: impairments.snr_m2m4(Z64 + 1, **d),
    "blank_impulses": lambda **d: impairments.blank_impulses(Z64 + 1, guard=1, train=4, **d),
    "pulse_compress": lambda **d: radar.pulse_compress(np.ones((4, 64), np.complex64),
                                                       Z64[:8] + 1, **d),
    "range_doppler": lambda **d: radar.range_doppler(np.ones((4, 64), np.complex64),
                                                     Z64[:8] + 1, **d),
    "cfar_2d": lambda **d: radar.cfar_2d(np.ones((16, 16), np.float32), **d),
    "fam_scf": lambda **d: cyclo.fam_scf(np.ones(512, np.complex64), np_=16, p=8, **d),
    "accel_search": lambda **d: accel.accel_search(Z64 + 1, max_drift=1e-4, **d),
    "mp_basis": lambda **d: dpd.mp_basis(Z64, 3, 2, **d),
    "pa_saleh": lambda **d: dpd.pa_saleh(Z64, **d),
    "pa_memory_polynomial": lambda **d: dpd.pa_memory_polynomial(
        np.ones(4, np.complex64), 3, 2, Z64, **d),
    "make_dpd_params": lambda **d: dpd.make_dpd_params(3, 2, **d),
    "lin_gain_ls": lambda **d: dpd.lin_gain_ls(Z64 + 1, Z64 + 1, **d),
    "dpd_identify_ila": lambda **d: dpd.dpd_identify_ila(Z64 + 1, Z64 + 1, 1, 1, 1.0, **d),
    "dpd_train_ila": lambda **d: dpd.dpd_train_ila(lambda z: z, Z64 + 1, 1, 1, iters=1, **d),
    "fresh_frames": lambda **d: fresh.fresh_frames(Z64, FRESH_BR, 4, **d),
    "fresh_design": lambda **d: fresh.fresh_design(Z64 + 1, Z64 + 1, FRESH_BR, taps=4, **d),
    "fresh_apply": lambda **d: fresh.fresh_apply(FRESH_F, Z64, **d),
    "make_fresh_planes": lambda **d: fresh_planes.make_fresh_planes(FRESH_F, **d),
    "ula_steering": lambda **d: array.ula_steering(4, 0.5, [0.0, 0.1], **d),
    "sample_covariance": lambda **d: array.sample_covariance(np.ones((4, 16), np.complex64), **d),
    "cov_init": lambda **d: array.cov_init(4, **d),
    "zf_detect": lambda **d: mimo.zf_detect(H22, np.ones((2, 8), np.complex64), **d),
    "mmse_detect": lambda **d: mimo.mmse_detect(H22, np.ones((2, 8), np.complex64), 10.0, **d),
    "ml_detect": lambda **d: mimo.ml_detect(H22, np.ones((2, 8), np.complex64), *LATTICE, **d),
    "fresh_filter_from": lambda **d: convert.fresh_filter_from(FRESH_F, **d),
    "dpd_params_from": lambda **d: convert.dpd_params_from(dpd.make_dpd_params(3, 2, device="cpu"),
                                                           **d),
    "dpd_state_from": lambda **d: convert.dpd_state_from(
        dpd.dpd_init(dpd.make_dpd_params(3, 2, device="cpu")), **d),
    "cov_state_from": lambda **d: convert.cov_state_from(array.cov_init(4, device="cpu"), **d),
    "moment_state_from": lambda **d: convert.moment_state_from(
        impairments.moments_init(device="cpu"), **d),
    # the protocol receivers: captures, factories, and what takes a factory's output
    "complex_audio": lambda **d: fsk.complex_audio(np.zeros(8, np.float32), **d),
    "decode_ax25_audio": lambda **d: ax25.decode_ax25_audio(
        np.zeros(1100, np.float32), 11, 1200 / 13200, 2200 / 13200, **d),
    "demod_acars_bits": lambda **d: acars.demod_acars_bits(np.zeros(2000, np.float32), 20, **d),
    "decode_acars_audio": lambda **d: acars.decode_acars_audio(np.zeros(2000, np.float32), 20,
                                                               **d),
    "rds_syndromes": lambda **d: rds.rds_syndromes(np.zeros(40, np.int32), **d),
    "rds_demod_mpx": lambda **d: rds.rds_demod_mpx(NOISE[:600], 19 / 228, 4, **d),
    "decode_navtex_audio": lambda **d: navtex.decode_navtex_audio(np.ones(2000, np.complex64),
                                                                  20, 0.05, **d),
    "decode_rtty": lambda **d: rtty.decode_rtty(np.ones(400, np.complex64), 10, 0.04, **d),
    "decode_same_audio": lambda **d: same.decode_same_audio(np.zeros(2400, np.float32), **d),
    "make_gps_acq": lambda **d: gps.make_gps_acq(1, 1, **d),
    "acquire_ca": lambda **d: gps.acquire_ca(gps.make_gps_acq(1, 1, **d),
                                             np.ones(2046, np.complex64), [0.0, 1e-4]),
    "acquire_ca_planes": lambda **d: gps.acquire_ca_planes(
        gps.make_gps_acq(1, 1, **d), np.ones(2046, np.float32), np.zeros(2046, np.float32), [0.0]),
    "track_ca": lambda **d: gps.track_ca(gps.make_gps_acq(1, 1, **d), np.ones(2046, np.complex64),
                                         {"p_idx": torch.tensor(3)},
                                         {"doppler": torch.tensor(0.0)}),
    "make_apt_params": lambda **d: apt.make_apt_params(**d),
    "apt_envelope": lambda **d: apt.apt_envelope(apt.make_apt_params(**d), NOISE[:2000]),
    "apt_decode_mpx": lambda **d: apt.apt_decode_mpx(apt.make_apt_params(**d), NOISE),
    "make_sstv_params": lambda **d: sstv.make_sstv_params(height=1, **d),
    "sstv_inst_freq": lambda **d: sstv.sstv_inst_freq(sstv.make_sstv_params(height=1, **d),
                                                      NOISE[:500]),
    "sstv_decode": lambda **d: sstv.sstv_decode(sstv.make_sstv_params(height=1, **d), NOISE[:500]),
    "gps_acq_from_jax": lambda **d: convert.gps_acq_from_jax(
        _JaxLike(shifts_t=np.eye(4, dtype=np.float32), n=4, sps=1, prn=1), **d),
    "apt_params_from_jax": lambda **d: convert.apt_params_from_jax(
        _JaxLike(fs=20800.0, sps=5.0, lo=0.1, hi=0.95, lp_taps=np.ones(5, np.float32)), **d),
    "sstv_params_from_jax": lambda **d: convert.sstv_params_from_jax(
        _JaxLike(fs=11025.0, width=320, height=1, lp_taps=np.ones(6, np.float32)), **d),
    "cli.main gen": lambda **d: _cli(["gen", "{dir}/g.cf32", "--num-samples", "64"], **d),
    "cli.main fir": lambda **d: _cli(["fir", "{dir}/in.cf32", "{dir}/out.cf32", "--taps", "8",
                                      "--decim", "2", "--block", "256"], **d),
    "cli.main fecdec": lambda **d: _cli(["fecdec", "{dir}/in.cf32", "{dir}/b.u8", "--code",
                                         "ldpc", "--fec-n", "120", "--hard"], **d),
}

# Host sinks: they copy a tensor from any device to the host once and never
# resolve a device, so they run with no card; a tensor and a numpy array give
# the same answer.
_RNG = np.random.default_rng(0)
BITS = _RNG.integers(0, 2, 4000).astype(np.int32)
AIS_LV = np.concatenate([BITS[:100], ais.build_ais_frame(bytes(range(12))), BITS[:60]])
MAG = np.concatenate([np.zeros(50, np.float32),
                      adsb.modulate(adsb.build_frame(BITS[:88])), np.zeros(50, np.float32)])
APT_P = apt.make_apt_params(device="cpu")
SSTV_P = sstv.make_sstv_params(height=1, device="cpu")
NOISE_WORDS = _RNG.random(5000).astype(np.float32)
HOST_SINKS = {
    "ais.decode_ais_frame": (ais.decode_ais_frame, AIS_LV),
    "ais.decode_all_ais_frames": (ais.decode_all_ais_frames, AIS_LV),
    "ais.nrzi_decode": (ais.nrzi_decode, AIS_LV),
    "ais.ais_fcs": (ais.ais_fcs, BITS[:64]),
    "ble.decode_adv_frame": (ble.decode_adv_frame, np.concatenate(
        [BITS[:30], ble.build_adv_frame(b"abc"), BITS[:20]])),
    "ble.whiten_bits": (lambda b: ble.whiten_bits(b, 37), BITS[:64]),
    "ble.crc24": (ble.crc24, BITS[:64]),
    "adsb.detect_preambles": (adsb.detect_preambles, MAG),
    "adsb.decode_frame": (adsb.decode_frame, MAG),
    "adsb.decode_all_frames": (adsb.decode_all_frames, MAG),
    "adsb.modes_crc": (adsb.modes_crc, BITS[:112]),
    "acars.bits_chars": (acars.bits_chars, BITS[:800]),
    "acars.parse_acars_chars": (acars.parse_acars_chars, acars.bits_chars(
        acars.build_acars_frame(b"HI")[168:168 + 8 * 20])),
    "pocsag.decode_transmission": (pocsag.decode_transmission, pocsag.encode_transmission(
        [(1234567, 0, [5])], preamble_bits=32)),
    "rds.rds_sync_decode": (rds.rds_sync_decode, np.concatenate(
        [BITS[:9], rds.rds_encode_group([1, 2, 3, 4]), BITS[:30]])),
    "gps.nav_preamble_detect": (gps.nav_preamble_detect, BITS[:300]),
    "navtex.sitor_b_decode": (navtex.sitor_b_decode,
                              navtex.sitor_b_encode(navtex._text_codes("ZCZC AB12 X NNNN"))),
    "rtty.uart_deframe": (rtty.uart_deframe, rtty.uart_frame(rtty.ita2_encode("RY RY"))),
    "rtty.ita2_decode": (rtty.ita2_decode, np.asarray(rtty.ita2_encode("CQ 73"))),
    "apt.apt_find_sync": (apt.apt_find_sync, NOISE_WORDS),
    "apt.apt_decode_lines": (lambda w: apt.apt_decode_lines(APT_P, w), NOISE_WORDS),
    "sstv.sstv_decode_vis": (lambda f: sstv.sstv_decode_vis(SSTV_P, f),
                             np.full(20000, 1900.0, np.float32)),
    "cw.decode_cw": (lambda a: cw.decode_cw(a, 8000.0), cw.cw_modulate("TEST", 20, 8000.0, 600.0)),
    "dcf77.dcf77_decode": (dcf77.dcf77_decode, dcf77.dcf77_modulate(
        [dcf77.dcf77_encode_minute(dcf77.Dcf77Time(1, 2, 3, 4, 5, 6, False))])),
    "dcf77.dcf77_envelope_bits": (dcf77.dcf77_envelope_bits, dcf77.dcf77_modulate(
        [dcf77.dcf77_encode_minute(dcf77.Dcf77Time(1, 2, 3, 4, 5, 6, False))])),
}


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_device_is_the_card_and_raises_without_one(no_card, name):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name]()


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_cpu_on_request(name):
    ENTRY_POINTS[name](device="cpu")


def test_device_blocks_default_raises_without_card(no_card, tmp_path):
    path = str(tmp_path / "x.ci16")
    capture.write_capture(path, np.zeros(256, np.complex64))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(capture.device_blocks(path, 128))
    assert next(capture.device_blocks(path, 128, device="cpu")).device.type == "cpu"


def test_resolve(no_card):
    assert resolve("cpu") == torch.device("cpu")
    assert resolve(torch.device("cpu")) == torch.device("cpu")
    for dev in (None, "cuda", "cuda:0", torch.device("cuda", 1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve(dev)


def test_resolve_gives_the_indexed_current_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert resolve(None) == resolve("cuda") == torch.device("cuda", 0)
    assert resolve("cuda:1") == torch.device("cuda", 1)


def _same(a, b) -> bool:
    if isinstance(a, (tuple, list)):
        return type(a) is type(b) and len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and np.array_equal(a, b)
    return a == b


@pytest.mark.parametrize("name", sorted(HOST_SINKS))
def test_host_sinks_take_a_tensor_with_no_card(no_card, name):
    fn, x = HOST_SINKS[name]
    assert _same(fn(torch.as_tensor(x)), fn(x))


def test_protocol_modules_import_with_no_card():
    """The module constants (CRC specs, whitening machine, the BCH code) need
    no device at import, and the host codecs run with no card."""
    import os
    import subprocess
    import sys

    code = (
        "import torch\n"
        "assert not torch.cuda.is_available()\n"
        "from srcdsp_tpu_torch.chains import pocsag, ble, ais, acars, adsb\n"
        "assert pocsag.make_codeword([1] * 21).size == 32\n"
        "assert ble.crc24([1, 0, 1]).size == 24 and ais.ais_fcs([1, 0]) >= 0\n"
        "assert acars.acars_bcs([65]) >= 0 and adsb.modes_crc([1] * 112) >= 0\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=300, cwd=str(Path(__file__).resolve().parents[1]))
    assert out.returncode == 0, out.stderr
