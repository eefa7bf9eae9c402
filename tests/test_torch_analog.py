"""Port vs JAX package: the analog receivers, ``chains/analog``.

Fixtures (numpy, seeded), the reference tests' parameters
(``tests/unit/test_analog.py``, ``test_fm_stereo.py``) at 2^14 samples:
FM (decim 4, audio decim 2, de-emphasis tau 20, two channels of audio
tones), AM (center 0.21, depth 0.5, DC blocker 0.999), SSB upper and lower
(center 0.22, decim 2, bandwidth 0.04), the stereo MPX decoder (pilot
19/240, audio decim 4) and the full FM stereo receiver (center 0.07, decim
4, audio decim 4, 96 taps, de-emphasis tau 8). Every receiver is streamed
in 4 blocks; the JAX side runs jitted once per module, on the same IQ.

Contracts:

- bit-exact: `deemphasis_coeffs`, `onesided_taps`, `ssb_modulate` and
  `fm_stereo_mpx` (host numpy on both sides), the factories' taps and words;
- rel L2 <= 1e-5: every receiver's audio and every carried state field
  (one pass a block; the de-emphasis and DC-block IIRs carry one [p]
  state between blocks), `am_modulate`;
- `fm_modulate`'s phase within 1e-3 rad of JAX's, and of the exact
  float64 phase: it is a float32 running sum over the whole signal (2^14
  steps to ~490 cycles), whose rounding depends on the summation order
  XLA and torch choose (measured: 4.9e-4 rad between them, 2.3e-4 (torch)
  and 4.2e-4 (XLA) from float64); the receivers' tests feed both sides the
  same IQ;
- a JAX state handed to the port after block 2 gives JAX's blocks 3-4, for
  every receiver.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu.chains import analog as ja
from srcdsp_tpu_torch import convert
from srcdsp_tpu_torch.chains import analog as ta
from tests.torch_threads import one_torch_thread  # noqa: F401

N, BLOCKS, REL = 1 << 14, 4, 1e-5
FP = 19.0 / 240.0


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _leaves(s):
    if s is None:
        return []
    return [x for v in s for x in _leaves(v)] if isinstance(s, tuple) else [s]


def _audio(f, amp=0.7):
    return (amp * np.sin(2 * np.pi * f * np.arange(N))).astype(np.float32)


def _cases():
    """name -> (JAX params, port params from the same arguments, IQ input)."""
    k = np.arange(N)
    a2 = np.stack([_audio(0.004), _audio(0.0031, 0.5)])
    fm_iq = np.asarray(ja.fm_modulate(jnp.asarray(a2), dev=0.02, center=0.03))
    am_iq = np.asarray(ja.am_modulate(jnp.asarray(_audio(0.003)), depth=0.5, center=0.21))
    ssb_audio = 0.6 * np.sin(2 * np.pi * 0.006 * k) + 0.3 * np.sin(2 * np.pi * 0.011 * k)
    left = 0.5 * np.cos(2 * np.pi * 0.001 * k)
    right = 0.5 * np.cos(2 * np.pi * 0.009 / 4 * k)
    mpx_rx = ja.fm_stereo_mpx(left, right, FP / 4)
    stereo_rx_iq = np.asarray(ja.fm_modulate(jnp.asarray(mpx_rx), dev=0.02, center=0.07))
    mpx = ja.fm_stereo_mpx(_audio(0.004, 0.5), _audio(0.0066, 0.5), FP)
    return {
        "fm": (ja.make_fm_params(0.03, 4, dev=0.08, audio_decim=2, deemph_tau=20.0),
               dict(fn="fm", args=(0.03, 4), kw=dict(dev=0.08, audio_decim=2, deemph_tau=20.0)),
               fm_iq.astype(np.complex64)),
        "am": (ja.make_am_params(0.21, 4, audio_decim=2),
               dict(fn="am", args=(0.21, 4), kw=dict(audio_decim=2)), am_iq.astype(np.complex64)),
        "usb": (ja.make_ssb_params(0.22, 2, 0.04),
                dict(fn="ssb", args=(0.22, 2, 0.04), kw={}),
                ja.ssb_modulate(ssb_audio, center=0.22)),
        "lsb": (ja.make_ssb_params(0.22, 2, 0.04, lower=True),
                dict(fn="ssb", args=(0.22, 2, 0.04), kw=dict(lower=True)),
                ja.ssb_modulate(ssb_audio, center=0.22, lower=True)),
        "stereo": (ja.make_fm_stereo_params(FP, audio_bw=0.06, audio_decim=4),
                   dict(fn="stereo", args=(FP,), kw=dict(audio_bw=0.06, audio_decim=4)), mpx),
        "stereo_rx": (ja.make_fm_stereo_rx(0.07, 4, dev=0.08, pilot=FP, audio_decim=4,
                                           num_taps=96, deemph_tau=8.0),
                      dict(fn="stereo_rx", args=(0.07, 4),
                           kw=dict(dev=0.08, pilot=FP, audio_decim=4, num_taps=96,
                                   deemph_tau=8.0)),
                      stereo_rx_iq.astype(np.complex64)),
    }


J_FNS = {"fm": (ja.fm_init, ja.fm_apply), "am": (ja.am_init, ja.am_apply),
         "ssb": (ja.ssb_init, ja.ssb_apply), "stereo": (ja.fm_stereo_init, ja.fm_stereo_apply),
         "stereo_rx": (ja.fm_stereo_rx_init, ja.fm_stereo_rx_apply)}
T_FNS = {"fm": (ta.make_fm_params, ta.fm_init, ta.fm_apply, convert.fm_params_from,
                convert.fm_state_from),
         "am": (ta.make_am_params, ta.am_init, ta.am_apply, convert.am_params_from,
                convert.am_state_from),
         "ssb": (ta.make_ssb_params, ta.ssb_init, ta.ssb_apply, convert.ssb_params_from,
                 convert.ssb_state_from),
         "stereo": (ta.make_fm_stereo_params, ta.fm_stereo_init, ta.fm_stereo_apply,
                    convert.stereo_params_from, convert.stereo_state_from),
         "stereo_rx": (ta.make_fm_stereo_rx, ta.fm_stereo_rx_init, ta.fm_stereo_rx_apply,
                       convert.fm_stereo_rx_params_from, convert.fm_stereo_rx_state_from)}
NAMES = ["fm", "am", "usb", "lsb", "stereo", "stereo_rx"]


@pytest.fixture(scope="module")
def ref():
    out = {}
    for name, (jp, spec, x) in _cases().items():
        init, apply = J_FNS[spec["fn"]]
        step = jax.jit(lambda s, v, apply=apply, jp=jp: apply(jp, s, v))
        lead = x.shape[:-1]
        st = init(jp, lead)
        blk = x.shape[-1] // BLOCKS
        states, outs = [], []
        for b in range(BLOCKS):
            st, y = step(st, jnp.asarray(x[..., b * blk:(b + 1) * blk]))
            states.append(st)
            outs.append(np.asarray(y))
        out[name] = dict(jp=jp, spec=spec, x=x, states=states, outs=outs)
    return out


def _run(case, params, state, start):
    _, init, apply, _, _ = T_FNS[case["spec"]["fn"]]
    x = case["x"]
    st = init(params, x.shape[:-1]) if state is None else state
    blk = x.shape[-1] // BLOCKS
    outs = []
    for b in range(start, BLOCKS):
        st, y = apply(params, st, torch.as_tensor(x[..., b * blk:(b + 1) * blk]))
        outs.append(y)
    return st, outs


def _check(outs, jouts, st, jst):
    for y, jy in zip(outs, jouts):
        assert y.dtype == torch.float32 and tuple(y.shape) == jy.shape
        assert rel(y.numpy(), jy) <= REL
    tl, jl = _leaves(st), _leaves(jst)
    assert len(tl) == len(jl)
    for p, r in zip(tl, jl):
        r = np.asarray(r)
        if r.dtype == np.uint32:
            np.testing.assert_array_equal(p.numpy(), r.astype(np.int64))
        else:
            assert tuple(p.shape) == r.shape and rel(p.numpy(), r) <= REL


@pytest.mark.parametrize("name", NAMES)
def test_receiver_stream_equal(ref, name):
    case = ref[name]
    make = T_FNS[case["spec"]["fn"]][0]
    params = make(*case["spec"]["args"], **case["spec"]["kw"], device="cpu")
    st, outs = _run(case, params, None, 0)
    _check(outs, case["outs"], st, case["states"][-1])


@pytest.mark.parametrize("name", NAMES)
def test_receiver_jax_state_handoff(ref, name):
    case = ref[name]
    _, _, _, params_from, state_from = T_FNS[case["spec"]["fn"]]
    params = params_from(case["jp"], device="cpu")
    st, outs = _run(case, params, state_from(case["states"][1], device="cpu"), 2)
    _check(outs, case["outs"][2:], st, case["states"][-1])


@pytest.mark.parametrize("name", NAMES)
def test_params_round_trip(ref, name):
    case = ref[name]
    make, _, _, params_from, _ = T_FNS[case["spec"]["fn"]]
    got = params_from(case["jp"], device="cpu")
    want = make(*case["spec"]["args"], **case["spec"]["kw"], device="cpu")
    flat = [x for v in vars(want).values() for x in (vars(v).values() if hasattr(v, "__dict__")
                                                     else [v])]
    flat_got = [x for v in vars(got).values() for x in (vars(v).values() if hasattr(v, "__dict__")
                                                        else [v])]
    assert len(flat) == len(flat_got)
    for a, b in zip(flat_got, flat):
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert a == b


def test_helpers_equal():
    for tau in (8.0, 20.0, 3.6):
        for a, b in zip(ta.deemphasis_coeffs(tau), ja.deemphasis_coeffs(tau)):
            np.testing.assert_array_equal(a, b)
    for lower in (False, True):
        np.testing.assert_array_equal(ta.onesided_taps(129, 0.08, lower=lower),
                                      ja.onesided_taps(129, 0.08, lower=lower))
    audio = np.random.default_rng(0).standard_normal(1001)
    np.testing.assert_array_equal(ta.ssb_modulate(audio, 0.2, lower=True),
                                  ja.ssb_modulate(audio, 0.2, lower=True))
    l_, r_ = _audio(0.004), _audio(0.005)
    np.testing.assert_array_equal(ta.fm_stereo_mpx(l_, r_, FP), ja.fm_stereo_mpx(l_, r_, FP))


def test_modulators_equal():
    a = np.stack([_audio(0.004), _audio(0.0031, 0.5)])
    fm = ta.fm_modulate(torch.as_tensor(a), dev=0.02, center=0.03)
    assert fm.dtype == torch.complex64
    jfm = np.asarray(ja.fm_modulate(jnp.asarray(a), dev=0.02, center=0.03))
    exact = np.exp(2j * np.pi * np.cumsum(0.03 + 0.02 * a.astype(np.float64), axis=-1))
    for other in (jfm, exact):
        assert np.abs(np.angle(fm.numpy() * np.conj(other))).max() <= 1e-3
    am = ta.am_modulate(torch.as_tensor(a[0]), depth=0.5, center=0.21)
    assert rel(am.numpy(), ja.am_modulate(jnp.asarray(a[0]), depth=0.5, center=0.21)) <= REL
