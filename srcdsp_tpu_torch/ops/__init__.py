"""Primitive DSP ops (counterpart of ``srcdsp_tpu/ops``): `(state, block) ->
(state, block)` functions whose carried overlap buffers make block-streamed
output equal whole-signal processing."""

from srcdsp_tpu_torch.ops.fir import FirState, fir_init, fir_apply, fir_full  # noqa: F401
from srcdsp_tpu_torch.ops.nco import NcoState, nco_init, nco_apply, nco_phasor  # noqa: F401
from srcdsp_tpu_torch.ops.resample import ResampleState, resample_init, resample_apply  # noqa: F401
from srcdsp_tpu_torch.ops.fftconv import FftConvState, fftconv_init, fftconv_apply  # noqa: F401
from srcdsp_tpu_torch.ops.fft_planes import make_fft_planes  # noqa: F401
from srcdsp_tpu_torch.ops.cic import (  # noqa: F401
    CicState, cic_compensator, cic_decim_apply, cic_decim_init, cic_gain, cic_interp_apply,
    cic_interp_init,
)
from srcdsp_tpu_torch.ops.spectrum import (  # noqa: F401
    WelchState, frame_signal, spectrogram, welch, welch_stream_finalize, welch_stream_init,
    welch_stream_update,
)
from srcdsp_tpu_torch.ops.farrow import (  # noqa: F401
    FarrowState, farrow_apply, farrow_capacity, farrow_init, make_farrow_ratio,
)
from srcdsp_tpu_torch.ops.impairments import (  # noqa: F401
    MomentState, blank_impulses, cfo_fft_peak, cfo_kay, dc_offset, iq_imbalance_correct,
    iq_imbalance_estimate, moments_init, moments_update, snr_m2m4,
)
from srcdsp_tpu_torch.ops.halfband import (  # noqa: F401
    HalfbandState, cascade_apply, cascade_init, design_halfband, halfband_decim, halfband_init,
)
from srcdsp_tpu_torch.ops.iir import (  # noqa: F401
    IirParams, IirState, iir_init, iir_apply, iir_full, make_iir_params, make_sos_params,
    sos_init, sos_apply,
)
from srcdsp_tpu_torch.ops.agc import (  # noqa: F401
    AgcParams, AgcState, agc_init, agc_apply, agc_full, make_agc_params,
)
from srcdsp_tpu_torch.ops.planes import (  # noqa: F401
    fused_mix_fir_decim_planes, phase_coef_matrix, plane_hist_len,
)
from srcdsp_tpu_torch.ops.design import (  # noqa: F401
    bandpass, bandstop, equiripple, firls, freq_response, group_delay, highpass, kaiser_lowpass,
    kaiser_num_taps,
)
from srcdsp_tpu_torch.ops.decimplan import (  # noqa: F401
    DecimPlan, decim_plan_apply, decim_plan_init, plan_decimation, plan_response,
    single_stage_taps,
)
from srcdsp_tpu_torch.ops.cfar import ca_cfar, cfar_alpha, go_cfar_split  # noqa: F401
from srcdsp_tpu_torch.ops.ddc import (  # noqa: F401
    DdcParams, DdcState, ddc_apply, ddc_init, make_ddc,
)
from srcdsp_tpu_torch.ops.afc import (  # noqa: F401
    AfcParams, AfcState, afc_apply, afc_init, make_afc,
)
from srcdsp_tpu_torch.ops.dpd import (  # noqa: F401
    DpdParams, DpdState, dpd_apply, dpd_full, dpd_identify_ila, dpd_init, dpd_train_ila,
    lin_gain_ls, make_dpd_params, mp_basis, mp_num_coeffs, pa_memory_polynomial, pa_saleh,
)
