"""Port vs JAX package and the C++ oracle: config 2 (NCO mix + 128-tap FIR +
rational 3/4 resample, 4 channels) and the port's oracle binding.

Contracts:

- `build_config2` against the JAX preset on the same input: inputs equal,
  outputs rel L2 < 1e-5 (float32 in another order), carried NCO words equal;
- against the C++ oracle (double accumulation): SNR > 90 dB, the reference's
  bar (tests/e2e/test_configs.py:63-78);
- the port's oracle binding: arrays equal to ``srcdsp_tpu.oracle``'s on the
  same input (one C++ source);
- `build_config2_onchip` on the CPU (plain versions): the right shapes, the
  fused, multichannel and pre-framed variants equal bit for bit on the same
  stream, the two-kernel chain and the plain chain within 90 dB of them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu import configs as jconfigs
from srcdsp_tpu import oracle as joracle
from srcdsp_tpu.ops.nco import freq_to_word
from srcdsp_tpu.ops.window import lowpass
from srcdsp_tpu_torch import configs as tconfigs
from srcdsp_tpu_torch import convert
from srcdsp_tpu_torch import oracle as toracle

N_ONCHIP = 98304  # one block of the widest variant (preframed_bf16io: 32 x 3072)


def _snr_db(ref, got) -> float:
    ref, got = np.asarray(ref), np.asarray(got)
    return float(10 * np.log10(np.mean(np.abs(ref) ** 2) / np.mean(np.abs(got - ref) ** 2)))


def _rel(got, ref) -> float:
    return float(np.linalg.norm(np.asarray(got) - np.asarray(ref)) / np.linalg.norm(ref))


def _oracle_chain(x, word):
    mixed, _ = toracle.nco_mix(x, 0, word)
    return toracle.resample(toracle.fir(mixed, lowpass(128, 0.2)), lowpass(48, 0.3), 3, 4)


def test_config2_matches_jax_preset():
    jb = jconfigs.build_config2(n=1 << 12, channels=2)
    tb = tconfigs.build_config2(n=1 << 12, channels=2, device="cpu")
    assert tb.samples_per_call == jb.samples_per_call == 2 * (1 << 12)
    np.testing.assert_array_equal(tb.example[-1].numpy(), np.asarray(jb.example[-1]))
    jn, jf, jr, jz = jb.step(*jb.example)
    tn, tf, tr, tz = tb.step(*tb.example)
    assert tz.shape == jz.shape == (2, 3 * (1 << 12) // 4)
    assert _rel(tz.numpy(), np.asarray(jz)) < 1e-5
    np.testing.assert_array_equal(tn.phase.numpy(), np.asarray(jn.phase).astype(np.int64))
    np.testing.assert_allclose(tr.tail.numpy(), np.asarray(jr.tail), rtol=0, atol=1e-5)


def test_config2_jax_state_continues_in_port():
    """Two blocks: the JAX step's state after block 1, converted, feeds the
    port's step for block 2, which then agrees with JAX's block 2."""
    jb = jconfigs.build_config2(n=1 << 12, channels=2)
    tb = tconfigs.build_config2(n=1 << 12, channels=2, device="cpu")
    x = np.array(jb.example[-1])
    half = x.shape[-1] // 2
    js = jb.step(*jb.example[:3], jnp.asarray(x[:, :half]))[:3]
    *js2, jz2 = jb.step(*js, jnp.asarray(x[:, half:]))
    ts = convert.config2_state_from(js, device="cpu")
    *ts2, tz2 = tb.step(*ts, torch.from_numpy(x[:, half:]))
    assert _rel(tz2.numpy(), np.asarray(jz2)) < 1e-5
    np.testing.assert_array_equal(ts2[0].phase.numpy(), np.asarray(js2[0].phase))
    np.testing.assert_allclose(ts2[2].tail.numpy(), np.asarray(js2[2].tail), rtol=0, atol=1e-5)


def test_config2_against_oracle():
    tb = tconfigs.build_config2(n=1 << 12, channels=2, device="cpu")
    *_, z = tb.step(*tb.example)
    word = int(freq_to_word(0.07))
    for c in range(2):
        ref = _oracle_chain(tb.example[-1][c].numpy(), word)
        assert _snr_db(ref, z[c].numpy()) > 90.0


def test_oracle_binding_equals_jax_binding():
    rng = np.random.default_rng(9)
    x = (rng.standard_normal(3000) + 1j * rng.standard_normal(3000)).astype(np.complex64)
    word = int(freq_to_word(0.13))
    a, ea = toracle.nco_mix(x, 12345, word)
    b, eb = joracle.nco_mix(x, 12345, word)
    np.testing.assert_array_equal(a, b)
    assert ea == eb
    taps = lowpass(33, 0.2)
    np.testing.assert_array_equal(toracle.fir(x, taps, decim=3), joracle.fir(x, taps, decim=3))
    np.testing.assert_array_equal(toracle.resample(x, taps, 3, 4),
                                  joracle.resample(x, taps, 3, 4))
    hist = np.zeros(11, np.complex64)
    ty, th, toff = toracle.resample_stream(x[:1200], taps, 3, 4, hist, 0)
    jy, jh, joff = joracle.resample_stream(x[:1200], taps, 3, 4, hist, 0)
    np.testing.assert_array_equal(ty, jy)
    np.testing.assert_array_equal(th, jh)
    assert toff == joff == 1200


def test_oracle_stream_blocks_join():
    rng = np.random.default_rng(10)
    x = (rng.standard_normal(2048) + 1j * rng.standard_normal(2048)).astype(np.complex64)
    taps = lowpass(48, 0.3)
    hist, off, outs = np.zeros(16, np.complex64), 0, []
    for lo, hi in ((0, 700), (700, 1500), (1500, 2048)):
        y, hist, off = toracle.resample_stream(x[lo:hi], taps, 3, 4, hist, off)
        outs.append(y)
    np.testing.assert_array_equal(np.concatenate(outs), toracle.resample(x, taps, 3, 4))
    with pytest.raises(ValueError, match="hist"):
        toracle.resample_stream(x, taps, 3, 4, np.zeros(3, np.complex64), 0)


def test_oracle_builds_in_the_port_build_directory():
    lib = toracle.build()
    assert lib == toracle.library_path() and lib.is_file()
    assert lib.parent.parent == toracle.BUILD_ROOT
    assert toracle.BUILD_ROOT.parts[-3:] == ("build", "srcdsp_tpu_torch", "oracle")


def _run(variant, channels=1):
    b = tconfigs.build_config2_onchip(N_ONCHIP, variant, channels=channels, device="cpu")
    yr, yi = b.step(*b.example)
    return b, yr, yi


@pytest.mark.parametrize("variant,shape", [("fused", (192, 384)), ("fused_mc", (3, 192, 384)),
                                           ("two_kernels", (1, 73728)),
                                           ("preframed", (64, 1152)),
                                           ("preframed_bf16io", (32, 2304))])
def test_onchip_variants_shapes(variant, shape):
    b, yr, yi = _run(variant, channels=3)
    assert tuple(yr.shape) == tuple(yi.shape) == shape
    assert yr.dtype == torch.float32 and bool(torch.isfinite(yr).all())
    assert b.samples_per_call == (3 if variant == "fused_mc" else 1) * N_ONCHIP


def test_onchip_variants_agree():
    _, fr, fi = _run("fused")
    _, mr, mi = _run("fused_mc", channels=2)
    _, pr, pi = _run("preframed")
    assert torch.equal(mr[0], fr) and torch.equal(mi[0], fi)
    assert torch.equal(pr.reshape(-1), fr.reshape(-1)) and torch.equal(pi.reshape(-1),
                                                                        fi.reshape(-1))
    ref = torch.complex(fr, fi).reshape(-1).numpy()
    _, tr, ti = _run("two_kernels")
    assert _snr_db(ref, torch.complex(tr, ti).reshape(-1).numpy()) > 90.0
    _, br, bi = _run("preframed_bf16io")
    assert _snr_db(ref, torch.complex(br, bi).reshape(-1).numpy()) > 40.0
    # the plain chain and the oracle on channel 1 of the multichannel stream
    b = tconfigs.build_config2_onchip(N_ONCHIP, "fused_mc", channels=2, device="cpu")
    x = b.example[0][1, :, b.meta["kernel"].hist:]
    xc = torch.complex(x[0], x[1])[None]
    st = tconfigs.build_config2(n=16, channels=1, device="cpu").example[:3]
    *_, z = tconfigs.config2_step(b.meta["words"][1:], "cpu")(*st, xc)
    got = torch.complex(mr[1], mi[1]).reshape(-1).numpy()
    assert _snr_db(z[0].numpy(), got) > 90.0
    assert _snr_db(_oracle_chain(xc[0].numpy(), b.meta["words"][1]), got) > 90.0


def test_onchip_rejects_unknown_variant_and_tiny_n():
    with pytest.raises(ValueError, match="variant"):
        tconfigs.build_config2_onchip(N_ONCHIP, "fused_combined_taps_bf16", device="cpu")
    with pytest.raises(ValueError, match="kernel block"):
        tconfigs.build_config2_onchip(1000, "fused", device="cpu")
