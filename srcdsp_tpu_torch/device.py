"""Where the port's entry points put their tensors.

Builders, kernel factories, stream classes and state constructors take
``device=None``, which means the card: the port runs on the GPU unless the
caller asks for the CPU (``device="cpu"``), as the CPU tests do. Nothing
falls back: with no CUDA device, a call that did not ask for the CPU raises.
"""

from __future__ import annotations

import numpy as np
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


def as_tensor_on(x, device=None, dtype=None) -> torch.Tensor:
    """A tensor stays on its own device (cast to `dtype` if given); anything
    else (numpy, a list) becomes a tensor on `device`, None = the card: the
    rule of the functions that take a capture."""
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(dtype)
    return torch.as_tensor(x, dtype=dtype, device=resolve(device))


def to_host(x) -> np.ndarray:
    """The rule of the host sinks: a tensor on any device is copied to the
    host once, as numpy; anything else goes through ``np.asarray``."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
