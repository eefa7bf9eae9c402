"""Port vs JAX package: ``ops/design`` (host numpy FIR design), bit-equal by
``np.array_equal``: the port keeps its own copy of the same numpy code."""

import numpy as np
import pytest

from srcdsp_tpu.ops import design as jd
from srcdsp_tpu_torch.ops import design as td
from tests.torch_threads import one_torch_thread  # noqa: F401

CASES = {
    "firls_lowpass": lambda m: m.firls(31, [0, 0.1, 0.2, 0.5], [1, 1, 0, 0]),
    "firls_weighted": lambda m: m.firls(45, [0, 0.08, 0.15, 0.5], [1, 1, 0, 0], [1, 10]),
    "firls_slope_fs": lambda m: m.firls(21, [0, 100, 200, 500], [0, 1, 0.5, 0], fs=1000.0),
    "equiripple": lambda m: m.equiripple(41, [0, 0.1, 0.18, 0.5], [1, 1, 0, 0], iters=25),
    "equiripple_ripple": lambda m: m.equiripple(33, [0, 0.12, 0.2, 0.5], [1, 1, 0, 0],
                                                [1, 5], iters=20, return_ripple=True),
    "highpass": lambda m: m.highpass(63, 0.2),
    "highpass_kaiser": lambda m: m.highpass(51, 0.3, window="kaiser", atten_db=70.0),
    "bandpass": lambda m: m.bandpass(64, 0.1, 0.2),
    "bandstop": lambda m: m.bandstop(65, 0.15, 0.25),
    "freq_response": lambda m: m.freq_response(m.bandpass(48, 0.05, 0.15), nfreq=257),
    "group_delay": lambda m: m.group_delay(m.highpass(31, 0.25), nfreq=129),
    "kaiser_num_taps": lambda m: m.kaiser_num_taps(80.0, 0.01),
    "kaiser_lowpass": lambda m: m.kaiser_lowpass(0.1, 0.02, atten_db=70.0, fs=2.0),
}


def _flat(v):
    if isinstance(v, tuple):
        return [np.asarray(a) for a in v]
    return [np.asarray(v)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_design_bit_equal(name):
    got, ref = _flat(CASES[name](td)), _flat(CASES[name](jd))
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        assert np.array_equal(g, r, equal_nan=True)


@pytest.mark.parametrize("call", [
    lambda m: m.firls(30, [0, 0.1, 0.2, 0.5], [1, 1, 0, 0]),
    lambda m: m.firls(31, [0, 0.3, 0.2, 0.5], [1, 1, 0, 0]),
    lambda m: m.equiripple(40, [0, 0.1, 0.2, 0.5], [1, 1, 0, 0]),
    lambda m: m.highpass(64, 0.2),
    lambda m: m.bandpass(64, 0.3, 0.2),
    lambda m: m.bandstop(64, 0.1, 0.2),
])
def test_design_errors_as_jax(call):
    with pytest.raises(ValueError):
        call(jd)
    with pytest.raises(ValueError):
        call(td)
