"""The hand-written CUDA kernels for Hopper (counterpart of
``srcdsp_tpu/kernels``), each behind a wrapper that runs its plain PyTorch
version on CPU tensors. The reference's one-shot ``*_pallas`` wrappers of
K1, K1 mc, K4 and K8 are the factories' call functions here (``make_*(...)
.fn``); K11's ``fftconv_pallas`` is called from its module
(``kernels.fftconv_pallas.fftconv_pallas``)."""

from srcdsp_tpu_torch.kernels.mixfir import (  # noqa: F401
    MixFirKernel, make_mix_fir_kernel, make_mix_fir_kernel_mc,
)
from srcdsp_tpu_torch.kernels.resample_pallas import (  # noqa: F401
    combine_fir_resample_taps, make_mix_resample_kernel, make_mix_resample_kernel_mc,
)
# not `fftconv_pallas`: the function would shadow its submodule of that name
from srcdsp_tpu_torch.kernels.fftconv_pallas import (  # noqa: F401
    FftConvKernel, FftConvStream, make_fftconv_kernel,
)
from srcdsp_tpu_torch.kernels.bank_pallas import (  # noqa: F401
    make_bank_kernel, make_bank_psk_kernel, phase_major,
)
from srcdsp_tpu_torch.kernels.fsk_fused import (  # noqa: F401
    demod_tail, fsk_demod_fused, make_fsk_mc_kernel,
)
from srcdsp_tpu_torch.kernels.fsk_ctaps import fsk_demod_ctaps, make_fsk_ctaps_kernel  # noqa: F401
from srcdsp_tpu_torch.kernels.mixfir_ctaps import (  # noqa: F401
    CtapsKernel, make_mix_fir_ctaps_kernel,
)
from srcdsp_tpu_torch.kernels.halo_dma import halo_from_left_pallas  # noqa: F401
from srcdsp_tpu_torch.kernels.halo_fused import (  # noqa: F401
    make_halo_fused_kernel, mix_fir_halo_sharded,
)
