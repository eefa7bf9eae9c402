"""Capture file I/O (counterpart of ``srcdsp_tpu/io``)."""

from srcdsp_tpu_torch.io.capture import (  # noqa: F401
    CaptureMeta, read_capture, write_capture, read_capture_blocks,
)
