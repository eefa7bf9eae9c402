"""srcdsp_tpu_torch: the PyTorch / CUDA port of srcdsp_tpu (config-4 FSK demod path).

Module paths mirror the JAX package (``ops/nco.py``, ``kernels/fsk_ctaps.py``
and so on). Plain tensor code is PyTorch; each Pallas kernel on the path is a
hand-written CUDA kernel under ``csrc/``, built with nvcc at first use
(``kernels/_build.py``). A kernel wrapper runs its plain PyTorch version for a
CPU tensor and launches the kernel for a CUDA tensor; it never falls back.
This package imports neither jax nor srcdsp_tpu.
"""

__version__ = "0.1.0"

from srcdsp_tpu_torch import types  # noqa: F401
from srcdsp_tpu_torch import ops  # noqa: F401
from srcdsp_tpu_torch import chains  # noqa: F401
from srcdsp_tpu_torch import io  # noqa: F401
from srcdsp_tpu_torch import checkpoint  # noqa: F401
from srcdsp_tpu_torch import fec  # noqa: F401
from srcdsp_tpu_torch import gf2  # noqa: F401
from srcdsp_tpu_torch import hdlc  # noqa: F401
from srcdsp_tpu_torch import rs  # noqa: F401
from srcdsp_tpu_torch import ldpc  # noqa: F401
from srcdsp_tpu_torch import qcldpc  # noqa: F401
from srcdsp_tpu_torch import turbo  # noqa: F401
from srcdsp_tpu_torch import polar  # noqa: F401
from srcdsp_tpu_torch import demap  # noqa: F401
from srcdsp_tpu_torch import array  # noqa: F401
from srcdsp_tpu_torch import mimo  # noqa: F401
from srcdsp_tpu_torch import metrics  # noqa: F401

# as in the reference, heavier subsystems stay import-on-demand:
#   srcdsp_tpu_torch.dist     (meshes, halos, re-shards, processes)
#   srcdsp_tpu_torch.kernels  (the CUDA kernels, built at first use)
#   srcdsp_tpu_torch.oracle   (builds the C++ golden model on first use)
