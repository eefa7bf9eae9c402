"""Test signals and channels (counterpart of ``srcdsp_tpu/testing``)."""

from srcdsp_tpu_torch.testing import signals  # noqa: F401
