"""Port vs JAX package: the concatenated CCSDS stack end to end, RS(255,223)
outer + K=7 rate-1/2 Viterbi inner over noisy BPSK, with a CRC-32 tag
(``tests/e2e/test_concat_coding.py``'s chain, numpy noise instead of a
`jax.random` key so both packages see the same channel).

- one message: every stage equal between the packages (codeword, coded
  bits, Viterbi decisions, RS output and `ok`, CRC), the inner decoder
  leaving symbol errors that the outer code removes;
- a batch through chip_smoke.py's phase-15 chain at small size: CRC-32 on
  the device (`gf2`) equal to `binascii.crc32`, RS encode, symbol
  interleaving at depth 4 (`block_interleave`, rows 4, cols 255), MSB-first
  bits, one terminated K=7 frame per group, BPSK at Eb/N0 2.5 dB (numpy seed
  1), Viterbi, deinterleave, RS decode, CRC: the port equal to the JAX
  package at each stage, every message back.
"""

import binascii

import jax
import jax.numpy as jnp
import numpy as np
import torch

from srcdsp_tpu import fec as jf
from srcdsp_tpu import gf2 as jg
from srcdsp_tpu import interleave as ji
from srcdsp_tpu import rs as jr
from srcdsp_tpu_torch import fec as tf
from srcdsp_tpu_torch import gf2 as tg
from srcdsp_tpu_torch import interleave as ti
from srcdsp_tpu_torch import rs as tr
from tests.torch_threads import one_torch_thread  # noqa: F401

GENS = (0o171, 0o133)
# Eb/N0 2.5 dB at rate 1/2: sigma = sqrt(1 / (2 R Eb/N0)), the reference test's
SIGMA = float(np.sqrt(1.0 / (2 * 0.5 * 10 ** (2.5 / 10))))
CRC32 = (0x04C11DB7, 32, 0xFFFFFFFF, 0xFFFFFFFF, True)


def _msb_bits(x: np.ndarray) -> np.ndarray:
    return ((x[..., None].astype(np.int32) >> np.arange(7, -1, -1)) & 1).reshape(*x.shape[:-1], -1)


def _soft(coded: np.ndarray, seed: int) -> np.ndarray:
    noise = (SIGMA * np.random.default_rng(seed).standard_normal(coded.shape)).astype(np.float32)
    return (1.0 - 2.0 * coded).astype(np.float32) + noise


def test_rs_viterbi_concatenated_noisy_channel_equal():
    jrs, trs = jr.make_rs_code(255, 223), tr.make_rs_code(255, 223, device="cpu")
    jcc, tcc = jf.make_conv_code(7, GENS), tf.make_conv_code(7, GENS)
    msg = np.random.default_rng(11).integers(0, 256, (1, 223), dtype=np.uint8)
    cw = tr.rs_encode(trs, torch.as_tensor(msg))
    np.testing.assert_array_equal(cw.numpy(), np.asarray(jr.rs_encode(jrs, jnp.asarray(msg))))
    bits = tg.byte_tensor_bits(cw)[0]
    np.testing.assert_array_equal(bits.numpy(), _msb_bits(cw.numpy()[0]))
    coded = tf.conv_encode(tcc, bits)
    np.testing.assert_array_equal(coded.numpy(), np.asarray(jf.conv_encode(jcc, jnp.asarray(bits))))
    soft = _soft(coded.numpy(), 3)
    hat = tf.viterbi_decode(tcc, torch.as_tensor(soft))
    jhat = jax.jit(lambda x: jf.viterbi_decode(jcc, x))(jnp.asarray(soft))
    np.testing.assert_array_equal(hat.numpy(), np.asarray(jhat))
    recv = (hat.reshape(1, 255, 8) << torch.arange(7, -1, -1)).sum(-1).to(torch.uint8)
    sym_errs = int((recv != cw).sum())
    assert 0 < sym_errs <= trs.t, sym_errs
    out, ok = tr.rs_decode(trs, recv)
    jout, jok = jr.rs_decode(jrs, jnp.asarray(recv.numpy()))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    assert bool(ok[0]) and bool(np.asarray(jok)[0])
    np.testing.assert_array_equal(out.numpy()[0], msg[0])
    spec, jspec = tg.make_crc(*CRC32), jg.make_crc(*CRC32)
    s = tg.crc_update(spec, tg.crc_init(spec, device="cpu"), tg.byte_tensor_bits(out, lsb_first=True))
    js = jg.crc_update(jspec, jg.crc_init(jspec),
                       jnp.asarray(jg.bytes_to_bits(np.asarray(jout)[0].tobytes(), lsb_first=True)))
    assert int(tg.crc_value(spec, s)[0]) == int(jg.crc_value(jspec, js)) == binascii.crc32(msg[0].tobytes())


def test_interleaved_link_batch_equal():
    """chip_smoke.py phase 15's CCSDS chain at 8 messages (2 groups of I = 4)."""
    depth, nmsg = 4, 8
    jrs, trs = jr.make_rs_code(255, 223), tr.make_rs_code(255, 223, device="cpu")
    jcc, tcc = jf.make_conv_code(7, GENS), tf.make_conv_code(7, GENS)
    spec = tg.make_crc(*CRC32)
    msg = np.random.default_rng(0).integers(0, 256, (nmsg, 223), dtype=np.uint8)
    crc = tg.crc_value(spec, tg.crc_update(spec, tg.crc_init(spec, device="cpu"),
                                           tg.byte_tensor_bits(torch.as_tensor(msg), lsb_first=True)))
    assert crc.tolist() == [binascii.crc32(m.tobytes()) for m in msg]
    cw = tr.rs_encode(trs, torch.as_tensor(msg))
    groups = ti.block_interleave(cw.reshape(nmsg // depth, depth * 255), depth, 255)
    np.testing.assert_array_equal(
        groups.numpy(), np.asarray(ji.block_interleave(jnp.asarray(cw.numpy()).reshape(2, -1),
                                                       depth, 255)))
    info = tg.byte_tensor_bits(groups)                          # [2, 8160]
    coded = tf.conv_encode(tcc, info)                           # [2, 16332]
    assert coded.shape == (2, 2 * (8160 + 6))
    soft = _soft(coded.numpy(), 1)
    hat = tf.viterbi_decode(tcc, torch.as_tensor(soft))
    jdec = jax.jit(lambda s: jf.viterbi_decode(jcc, s))
    np.testing.assert_array_equal(hat.numpy(), np.asarray(jdec(jnp.asarray(soft))))
    inner_bit_errs = int((hat != info).sum())
    rx = (hat.reshape(2, depth * 255, 8) << torch.arange(7, -1, -1)).sum(-1).to(torch.uint8)
    recv = ti.block_deinterleave(rx, depth, 255).reshape(nmsg, 255)
    assert int((recv != cw).sum()) > 0, inner_bit_errs
    out, ok = tr.rs_decode(trs, recv)
    jout, jok = jr.rs_decode(jrs, jnp.asarray(recv.numpy()))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert bool(ok.all())
    np.testing.assert_array_equal(out.numpy(), msg)
    back = tg.crc_value(spec, tg.crc_update(spec, tg.crc_init(spec, device="cpu"),
                                            tg.byte_tensor_bits(out, lsb_first=True)))
    assert torch.equal(back, crc)
