"""srcdsp_tpu_torch: the PyTorch / CUDA port of srcdsp_tpu (config-4 FSK demod path).

Module paths mirror the JAX package (``ops/nco.py``, ``kernels/fsk_ctaps.py``
and so on). Plain tensor code is PyTorch; each Pallas kernel on the path is a
hand-written CUDA kernel under ``csrc/``, built with nvcc at first use
(``kernels/_build.py``). A kernel wrapper runs its plain PyTorch version for a
CPU tensor and launches the kernel for a CUDA tensor; it never falls back.
This package imports neither jax nor srcdsp_tpu.
"""
