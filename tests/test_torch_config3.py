"""Port vs JAX package and the C++ oracle: config 3 (overlap-save FFT
convolution, 4096 points, 1024 taps) and the FFT builders.

Contracts:

- `build_config3` against the JAX preset on the same seeded input: inputs
  equal, outputs SNR > 120 dB (two complex64 FFT libraries), carried tails
  equal, over two calls with the state carried; against the C++ oracle's
  direct FIR: > 90 dB, the reference's bar (tests/e2e/test_configs.py:81-89);
- `build_config3_onchip` on the CPU (plain versions): finite outputs of the
  stated shapes; ``fused`` > 90 dB against the oracle; ``fused_per_channel``
  equal to ``fused`` bit for bit (the same taps per channel); ``planes``
  (hop 2048) > 100 dB against ``fused`` (hop 3072) on the common prefix;
- `build_fft`: every variant finite; ``kernel`` == ``kernel_nat`` == the
  unscrambled ``kernel_digit`` bit for bit; ``kernel`` and ``planes`` > 110 dB
  against numpy.
"""

import numpy as np
import pytest
import torch

from srcdsp_tpu import configs as jconfigs
from srcdsp_tpu.ops.window import lowpass
from srcdsp_tpu_torch import configs as tconfigs
from srcdsp_tpu_torch import oracle as toracle
from srcdsp_tpu_torch.kernels.fft_pallas import unscramble
from tests.torch_threads import one_torch_thread  # noqa: F401

N_ONCHIP = 2 * 49152  # two K11 blocks at the serving tiling (b_frames 16, hop 3072)


def _snr_db(ref, got) -> float:
    ref, got = np.asarray(ref), np.asarray(got)
    err = np.mean(np.abs(got - ref) ** 2)
    return float(10 * np.log10(np.mean(np.abs(ref) ** 2) / (err + 1e-30)))


def test_config3_matches_jax_preset_with_state_carried():
    jb = jconfigs.build_config3(n=1 << 14, channels=3)
    tb = tconfigs.build_config3(n=1 << 14, channels=3, device="cpu")
    assert tb.samples_per_call == jb.samples_per_call == 3 * 5 * 3073
    np.testing.assert_array_equal(tb.example[1].numpy(), np.asarray(jb.example[1]))
    jst, x = jb.example
    tst, tx = tb.example
    for _ in range(2):
        jst, jy = jb.step(jst, x)
        tst, ty = tb.step(tst, tx)
        assert _snr_db(np.asarray(jy), ty.numpy()) > 120
        np.testing.assert_array_equal(tst.tail.numpy(), np.asarray(jst.tail))


def test_config3_against_oracle():
    tb = tconfigs.build_config3(n=1 << 14, channels=3, device="cpu")
    st, x = tb.example
    _, y = tb.step(st, x)
    taps = lowpass(1024, 0.1)
    for c in range(3):
        assert _snr_db(toracle.fir(x[c].numpy(), taps), y[c].numpy()) > 90


def _onchip(variant, channels=2):
    b = tconfigs.build_config3_onchip(N_ONCHIP, variant, channels=channels, device="cpu")
    yr, yi = b.step(*b.example)
    return b, yr, yi


@pytest.mark.parametrize("variant,hop", [("fused", 3072), ("fused_per_channel", 3072),
                                         ("planes", 2048)])
def test_onchip_variants_shapes(variant, hop):
    b, yr, yi = _onchip(variant)
    assert tuple(yr.shape) == tuple(yi.shape) == (2, N_ONCHIP)
    assert yr.dtype == torch.float32 and bool(torch.isfinite(yr).all() & torch.isfinite(yi).all())
    assert b.samples_per_call == 2 * N_ONCHIP and b.meta["hop"] == hop


def test_onchip_variants_agree_and_match_oracle():
    b, fr, fi = _onchip("fused")
    _, pr, pi = _onchip("fused_per_channel")
    assert torch.equal(pr, fr) and torch.equal(pi, fi)
    _, qr, qi = _onchip("planes")
    fused = torch.complex(fr, fi).numpy()
    assert _snr_db(fused, torch.complex(qr, qi).numpy()) > 100
    x = b.example[0][:, :, b.meta["kernel"].overlap:]
    taps = lowpass(1024, 0.1)
    for c in range(2):
        ref = toracle.fir(torch.complex(x[c, 0], x[c, 1]).numpy(), taps)
        assert _snr_db(ref, fused[c]) > 90


def test_onchip_rejects_unknown_variant_and_tiny_n():
    with pytest.raises(ValueError, match="variant"):
        tconfigs.build_config3_onchip(N_ONCHIP, "pallas_bf16", device="cpu")
    with pytest.raises(ValueError, match="block"):
        tconfigs.build_config3_onchip(1000, "fused", device="cpu")
    with pytest.raises(ValueError, match="variant"):
        tconfigs.build_fft(16, 1024, "cufft", device="cpu")


def test_fft_variants_agree():
    outs = {}
    for variant in tconfigs.FFT_VARIANTS:
        b = tconfigs.build_fft(40, 1024, variant, device="cpu")
        yr, yi = b.step(*b.example)
        assert bool(torch.isfinite(yr).all() & torch.isfinite(yi).all())
        assert b.samples_per_call == b.meta["batch"] * 1024
        outs[variant] = (yr, yi, b)
    nat_r, nat_i, b = outs["kernel"]
    assert b.meta["batch"] == 32 and b.meta["flops_5nlogn"] == 5 * 1024 * 10 * 32
    assert torch.equal(outs["kernel_nat"][0], nat_r) and torch.equal(outs["kernel_nat"][1], nat_i)
    dk = outs["kernel_digit"][2].meta["kernel"]
    assert torch.equal(unscramble(outs["kernel_digit"][0], dk.n1, dk.n2), nat_r)
    xr, xi = b.example
    ref = np.fft.fft(xr.numpy().astype(np.float64) + 1j * xi.numpy(), axis=-1)
    assert _snr_db(ref, torch.complex(nat_r, nat_i).numpy()) > 110
    pr, pi, bp = outs["planes"]
    xr, xi = bp.example                                   # batch 40: not rounded to b_frames
    ref = np.fft.fft(xr.numpy().astype(np.float64) + 1j * xi.numpy(), axis=-1)
    assert _snr_db(ref, torch.complex(pr, pi).numpy()) > 110
