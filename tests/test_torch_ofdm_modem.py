"""Port vs JAX package: the coded-OFDM receive modem, ``chains/ofdm_modem``.

Fixture (numpy, seeded), ``tests/e2e/test_ofdm_modem.py``'s: 2 channels x
4 codewords of the z = 16 dual-diagonal QC code (mb 4, nb 12), bit-plane
BICM onto 16-QAM OFDM (nfft 64, cp 16, 52 active, 2 pilot symbols) through
a two-tap channel at ~15 dB, 4 iterations.

The JAX pipeline is not run whole: its interpret-mode decoder costs minutes
on the CPU. The three stages are held separately instead:

- the receiver planes and the LLRs against JAX's jitted
  `make_ofdm_rx_planes` + `demap.qam_llr_bitplanes` (indices equal, planes
  and LLRs within rel L2 1e-5; measured <= 2e-7);
- the decode against JAX's eager `qc_decode_layered_ref` on the same LLRs:
  hard decisions equal (the port's decoder on a CPU tensor is K15's plain
  version);
- the port's `make_ofdm_coded_modem` end to end: every syndrome clean,
  decoded == transmitted codewords, and its bits equal to the staged
  decode's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu.chains import ofdm as jo
from srcdsp_tpu.chains.ofdm_planes import make_ofdm_rx_planes as jrx_planes
from srcdsp_tpu.demap import qam_llr_bitplanes as jllr
from srcdsp_tpu.kernels import ldpc_pallas as jlp
from srcdsp_tpu_torch.chains import modem as tm
from srcdsp_tpu_torch.chains import ofdm as to
from srcdsp_tpu_torch.chains.ofdm_modem import make_ofdm_coded_modem
from srcdsp_tpu_torch.chains.ofdm_planes import make_ofdm_rx_planes
from srcdsp_tpu_torch.chains.qam import qam_constellation
from srcdsp_tpu_torch.demap import qam_llr_bitplanes
from srcdsp_tpu_torch.kernels.ldpc_pallas import make_qc_decoder_t, plan_qc
from srcdsp_tpu_torch.qcldpc import make_dual_diagonal_base, make_qc_ldpc, qc_encode_dual_diagonal
from tests.torch_threads import one_torch_thread  # noqa: F401

C, NW, ORDER, Z, MB, NB, ITERS, N_PILOT = 2, 4, 16, 16, 4, 12, 4, 2
N, K = NB * Z, (NB - MB) * Z
SPC = N // 4
REL = 1e-5


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def to_cols(z, na):
    """[C, S, na] -> the decoder's [spc, C*nw] columns (codeword c*nw + w)."""
    flat = np.asarray(z).reshape(C, -1)[:, : NW * SPC]
    return np.ascontiguousarray(flat.reshape(C, NW, SPC).transpose(2, 0, 1).reshape(SPC, C * NW))


@pytest.fixture(scope="module")
def link():
    """The transmitted link, and JAX's three stages run once: the front end,
    the LLRs, and the reference decode of those LLRs."""
    base = make_dual_diagonal_base(MB, NB, Z, seed=0)
    rng = np.random.default_rng(0)
    u = rng.integers(0, 2, (C * NW, K))
    cw = qc_encode_dual_diagonal(base, Z, torch.as_tensor(u)).numpy()
    idx = tm.map_codewords_to_symbols(torch.as_tensor(cw), ORDER).numpy().reshape(C, NW * SPC)
    spec = to.make_ofdm_spec(64, 16, 52, ORDER)
    na = spec.active.size
    pts = qam_constellation(ORDER)
    s_data = -(-(NW * SPC) // na)
    fill = rng.integers(0, ORDER, (C, s_data * na - NW * SPC))
    grid = pts[np.concatenate([idx, fill], axis=1)].reshape(C, s_data, na)
    pilot = pts[rng.integers(0, ORDER, na)]
    y = []
    for ch in range(C):
        points = np.concatenate([np.tile(pilot[None], (N_PILOT, 1)), grid[ch]])
        tx = to.ofdm_modulate(spec, torch.as_tensor(points)).numpy()
        y.append(np.convolve(tx, np.array([1.0, 0.2 * np.exp(0.5j)]))[: tx.size])
    y = np.stack(y)
    y = y + 0.09 * (rng.standard_normal(y.shape) + 1j * rng.standard_normal(y.shape))
    kk = (y.shape[-1] // to.sym_len(spec)) * to.sym_len(spec)
    planes = [np.ascontiguousarray(a, np.float32)
              for a in (y.real[:, :kk], y.imag[:, :kk], pilot.real, pilot.imag)]

    jspec = jo.make_ofdm_spec(64, 16, 52, ORDER)
    jidx, (jzr, jzi) = jax.jit(jrx_planes(jspec, n_pilot=N_PILOT))(*map(jnp.asarray, planes))
    jl = jnp.concatenate(jllr(jnp.asarray(to_cols(jzr, na)), jnp.asarray(to_cols(jzi, na)),
                              ORDER), axis=0)
    jpost = jlp.qc_decode_layered_ref(jlp.plan_qc(base, Z), jl, iters=ITERS)
    return dict(base=base, cw=cw, spec=spec, planes=planes,
                jax=dict(idx=np.array(jidx), zr=np.array(jzr), zi=np.array(jzi),
                         llr=np.array(jl), bits_t=(np.asarray(jpost) < 0).astype(np.int32)))


def test_receiver_planes_and_llrs_equal_to_jax(link):
    ref = link["jax"]
    idx, (zr, zi) = make_ofdm_rx_planes(link["spec"], n_pilot=N_PILOT, device="cpu")(
        *map(torch.from_numpy, link["planes"]))
    llr = torch.cat(qam_llr_bitplanes(torch.from_numpy(to_cols(zr, 52)),
                                      torch.from_numpy(to_cols(zi, 52)), ORDER), dim=0)
    np.testing.assert_array_equal(idx.numpy(), ref["idx"])
    assert rel(zr.numpy(), ref["zr"]) <= REL and rel(zi.numpy(), ref["zi"]) <= REL
    assert llr.shape == (N, C * NW) and rel(llr.numpy(), ref["llr"]) <= REL


def _decoder(link):
    code = make_qc_ldpc(link["base"], Z, device="cpu")
    return make_qc_decoder_t(code, plan_qc(link["base"], Z), iters=ITERS, b_tile=C * NW,
                             device="cpu")


def test_decode_equal_to_jax_reference(link):
    """The same LLRs (JAX's) through the port's decoder and JAX's eager
    reference: hard decisions equal, every syndrome clean."""
    bits_t, ok = _decoder(link)(torch.from_numpy(link["jax"]["llr"]))
    np.testing.assert_array_equal(bits_t.numpy(), link["jax"]["bits_t"])
    assert bool(ok.all())


def test_modem_decodes_transmitted_codewords(link):
    code = make_qc_ldpc(link["base"], Z, device="cpu")
    pipe = make_ofdm_coded_modem(link["spec"], code, plan_qc(link["base"], Z), num_channels=C,
                                 nw=NW, iters=ITERS, b_tile=C * NW, n_pilot=N_PILOT,
                                 device="cpu")
    bits_t, ok = pipe(*map(torch.from_numpy, link["planes"]))
    assert bits_t.dtype == torch.int32 and bits_t.shape == (N, C * NW)
    assert bool(ok.all())
    np.testing.assert_array_equal(bits_t.numpy().T, link["cw"])
    np.testing.assert_array_equal(bits_t.numpy(), link["jax"]["bits_t"])


def test_modem_shape_errors(link):
    code = make_qc_ldpc(link["base"], Z, device="cpu")
    plan = plan_qc(link["base"], Z)
    with pytest.raises(ValueError, match="b_tile"):
        make_ofdm_coded_modem(link["spec"], code, plan, num_channels=3, nw=NW, b_tile=8,
                              device="cpu")
    with pytest.raises(ValueError, match="bits/symbol"):
        make_ofdm_coded_modem(to.make_ofdm_spec(order=64), code, plan_qc(link["base"][:, :10], Z),
                              num_channels=C, nw=NW, b_tile=8, device="cpu")
