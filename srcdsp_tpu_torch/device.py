"""Where the port's entry points put their tensors.

Builders, kernel factories, stream classes and state constructors take
``device=None``, which means the card: the port runs on the GPU unless the
caller asks for the CPU (``device="cpu"``), as the CPU tests do. Nothing
falls back: with no CUDA device, a call that did not ask for the CPU raises.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` -> the current CUDA device; anything else as given, with a
    bare ``cuda`` given its index (``cuda:0``), the device a tensor reports.
    Raises when the result is a CUDA device and torch sees none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"no CUDA device for {dev} (torch.cuda.is_available() is "
                               f"false); pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
