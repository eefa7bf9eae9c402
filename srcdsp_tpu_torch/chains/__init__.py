"""Composite demodulation chains (counterpart of ``srcdsp_tpu/chains``): each
chain is a `(params, state, block) -> (state, outputs)` function; N channels
are leading axes of the state, not N objects."""

from srcdsp_tpu_torch.chains.sync import (  # noqa: F401
    TimingState, timing_init, timing_estimate, timing_sample,
)
from srcdsp_tpu_torch.chains.fsk import (  # noqa: F401
    FskParams, FskState, fsk_init, fsk_apply, make_fsk_params,
)
from srcdsp_tpu_torch.chains.psk import (  # noqa: F401
    PskParams, PskState, make_psk_params, psk_apply, psk_init,
)
from srcdsp_tpu_torch.chains.tracking import (  # noqa: F401
    FskTrackState, PskTrackState, fsk_track_apply, fsk_track_init, psk_track_apply,
    psk_track_init, FskTrackRaggedState, PskTrackRaggedState, compact_ragged,
    fsk_track_ragged_apply, fsk_track_ragged_init, psk_track_ragged_apply,
    psk_track_ragged_init,
)
from srcdsp_tpu_torch.chains.tracking_planes import (  # noqa: F401
    FskTrackPlanesState, PskTrackPlanesState, costas_scan_planes, fsk_track_planes_apply,
    fsk_track_planes_init, gardner_scan_planes, psk_track_planes_apply, psk_track_planes_init,
)
from srcdsp_tpu_torch.chains.framesync import (  # noqa: F401
    FrameSyncParams, FrameSyncState, frame_sync_apply, frame_sync_init, make_frame_sync_params,
    peak_indices, peak_to_burst_start,
)
from srcdsp_tpu_torch.chains.qam import (  # noqa: F401
    QamParams, QamState, make_qam_params, qam_apply, qam_constellation, qam_demod_stream,
    qam_init, qam_modulate, qam_slice, quad_diff_decode, quad_diff_encode,
)
from srcdsp_tpu_torch.chains.analog import (  # noqa: F401
    AmParams, AmState, FmParams, FmState, SsbParams, SsbState, am_apply, am_init, am_modulate,
    fm_apply, fm_init, fm_modulate, make_am_params, make_fm_params, make_ssb_params, ssb_apply,
    ssb_init, ssb_modulate, StereoParams, StereoState, fm_stereo_apply, fm_stereo_init,
    fm_stereo_mpx, make_fm_stereo_params,
)
from srcdsp_tpu_torch.chains.equalizer import (  # noqa: F401
    DfeState, EqState, RlsState, cma_equalize, dfe_equalize, dfe_init, eq_init, lms_equalize,
    psk_slicer, rls_equalize, rls_init,
)
from srcdsp_tpu_torch.chains.ofdm import (  # noqa: F401
    OfdmSpec, make_ofdm_spec, ofdm_demod, ofdm_fft, ofdm_modulate, ofdm_rx, schmidl_cox_metric,
    schmidl_cox_preamble,
)
from srcdsp_tpu_torch.chains.dsss import (  # noqa: F401
    DsssParams, dsss_acquire, dsss_demod_bpsk, dsss_despread, dsss_spread, make_dsss_params,
    pn_msequence,
)
from srcdsp_tpu_torch.chains.dqpsk import (  # noqa: F401
    DqpskState, dqpsk_apply, dqpsk_baseband, dqpsk_demod_stream, dqpsk_init, dqpsk_slice,
    make_dqpsk_params,
)
from srcdsp_tpu_torch.chains.tx import (  # noqa: F401
    CpmTxParams, CpmTxState, LinearTxParams, LinearTxState, bits_to_indices, cpm_tx_apply,
    cpm_tx_init, gaussian_freq_pulse, linear_tx_apply, linear_tx_init, make_cpfsk_tx,
    make_gmsk_tx, make_linear_tx, psk_map, qam_map,
)
from srcdsp_tpu_torch.chains.blindscan import (  # noqa: F401
    Detection, baud_estimate, classify_mpsk, scan,
)
from srcdsp_tpu_torch.chains.msk import laurent_c0, msk_coherent_demod, pseudo_symbols  # noqa: F401
from srcdsp_tpu_torch.chains.scfde import (  # noqa: F401
    ScfdeSpec, make_scfde_spec, scfde_rx, scfde_tx,
)
from srcdsp_tpu_torch.chains.fhss import (  # noqa: F401
    FhssParams, fhss_acquire, fhss_dehop, fhss_hop, make_fhss_params,
)
from srcdsp_tpu_torch.chains.mlse import MlseTrellis, make_mlse, mlse_equalize  # noqa: F401
