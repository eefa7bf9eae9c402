"""The port's entry points run on the card unless the caller asks for the CPU.

Every builder, kernel factory, stream class and state constructor maps
``device=None`` to the CUDA device (``srcdsp_tpu_torch.device.resolve``).
With no card (``torch.cuda.is_available`` patched to False here), such a call
raises; it never quietly builds the plain CPU version. Passing
``device="cpu"`` runs on the CPU, as every CPU test does.
"""

import numpy as np
import pytest
import torch

from srcdsp_tpu_torch import configs, convert
from srcdsp_tpu_torch.chains import fsk, sync
from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.io import capture
from srcdsp_tpu_torch.kernels import fsk_ctaps, fsk_fused, fsk_preframed, mixfir
from srcdsp_tpu_torch.kernels import mixfir_ctaps, mixfir_preframed, resample_pallas
from srcdsp_tpu_torch.kernels import resample_preframed
from srcdsp_tpu_torch.ops import fir, nco, planes, resample
from srcdsp_tpu_torch.ops.window import lowpass

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


ENTRY_POINTS = {
    "build_config1": lambda **d: configs.build_config1(1 << 12, **d),
    "build_config1_kernel": lambda **d: configs.build_config1(1 << 12, use_kernel=True, **d),
    "build_config1_serving": lambda **d: configs.build_config1_serving(1 << 15, "ctaps", **d),
    "build_config2": lambda **d: configs.build_config2(1 << 10, 2, **d),
    "build_config2_onchip": lambda **d: configs.build_config2_onchip(1 << 14, "fused", **d),
    "build_config4": lambda **d: configs.build_config4(64, 2, **d),
    "make_mix_fir_kernel": lambda **d: mixfir.make_mix_fir_kernel(TAPS, 2, **d),
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
