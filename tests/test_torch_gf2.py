"""Port vs JAX package: GF(2) machines, scramblers and CRCs (``gf2``).

Contracts, all bit for bit on the same numpy inputs:

- the host block matrices (A^L, F, G, H) at the block and tail lengths;
- `gf2_apply` outputs and states for random machines (D 0 and 1), batched,
  and the scramblers (802.11, DVB) split anywhere: at 0, a tail only, inside
  a block, on block edges and over several blocks, equal to one call;
- the published check values (CRC-16/CCITT 0x29B1, CRC-32 0xCBF43926) and
  CRC-32 against `binascii.crc32`, one message and a batch;
- a register started in the JAX package continues in the port
  (`convert.gf2_state_from`) and comes back (`gf2_state_to_numpy`).
"""

import binascii
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu import gf2 as jg
from srcdsp_tpu_torch import convert
from srcdsp_tpu_torch import gf2 as tg
from tests.torch_threads import one_torch_thread  # noqa: F401

CRC32 = (0x04C11DB7, 32, 0xFFFFFFFF, 0xFFFFFFFF, True)


@functools.cache
def _scramblers(taps, order):
    """Both packages' machines, shared so each block length is built once."""
    return jg.make_scrambler(taps, order), tg.make_scrambler(taps, order)


@functools.cache
def _crc(spec):
    return jg.make_crc(*spec), tg.make_crc(*spec)


def _random_machine(rng, p, d, block):
    a = rng.integers(0, 2, (p, p))
    b = rng.integers(0, 2, p)
    c = rng.integers(0, 2, p)
    return jg.Gf2Machine(a, b, c, d, block), tg.Gf2Machine(a, b, c, d, block)


@pytest.mark.parametrize("length", [64, 37, 1])
def test_block_matrices_equal(length):
    jm, tm = _random_machine(np.random.default_rng(length), 9, 1, 64)
    for want, got in zip(jm.matrices(length), tm.host_matrices(length)):
        np.testing.assert_array_equal(got, np.asarray(want))
    par = tm.matrices(length, "cpu")
    assert par.h.dtype == torch.float32 and par.h.shape == (length, length)
    conv = convert.gf2_machine_from(jm)
    for want, got in zip(tm.host_matrices(length), conv.host_matrices(length)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("d", [0, 1])
@pytest.mark.parametrize("n", [0, 20, 64, 64 * 3 + 5])
def test_gf2_apply_equal(d, n):
    rng = np.random.default_rng(10 * n + d)
    jm, tm = _random_machine(rng, 7, d, 64)
    u = rng.integers(0, 2, (3, n))
    s0 = rng.integers(0, 2, (3, 7)).astype(np.float32)
    js, jy = jg.gf2_apply(jm, jnp.asarray(s0), jnp.asarray(u))
    ts, ty = tg.gf2_apply(tm, torch.as_tensor(s0), torch.as_tensor(u))
    assert ty.dtype == torch.int32 and ty.shape == (3, n)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("taps,order,seed", [((4, 7), 7, 0x5D), ((14, 15), 15, 0x4A80)])
@pytest.mark.parametrize("split", [0, 100, 512, 700, 1024, 2000])
def test_scrambler_streaming_splits_equal(taps, order, seed, split):
    """One call over 2000 bits (3 blocks of 512 and a tail) from the JAX
    package equals the port's two calls split at `split`."""
    jm, tm = _scramblers(taps, order)
    bits = np.random.default_rng(split).integers(0, 2, (2, 2000))
    js0 = jnp.broadcast_to(jg.gf2_init(jm, seed), (2, order))
    js, jy = jg.scramble(jm, js0, jnp.asarray(bits))
    s = tg.gf2_init(tm, seed, device="cpu")
    s, y1 = tg.scramble(tm, s, torch.as_tensor(bits[:, :split]))
    s, y2 = tg.scramble(tm, s, torch.as_tensor(bits[:, split:]))
    np.testing.assert_array_equal(torch.cat([y1, y2], -1).numpy(), np.asarray(jy))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    # self-inverse
    _, back = tg.scramble(tm, tg.gf2_init(tm, seed, device="cpu"), torch.cat([y1, y2], -1))
    np.testing.assert_array_equal(back.numpy(), bits)


def test_scrambler_tail_only_and_init_list():
    jm, tm = _scramblers((4, 7), 7)
    bits = np.random.default_rng(3).integers(0, 2, 100)
    state = [1, 0, 1, 1, 0, 0, 1]
    js, jy = jg.scramble(jm, jg.gf2_init(jm, state), jnp.asarray(bits))
    ts, ty = tg.scramble(tm, tg.gf2_init(tm, state, device="cpu"), torch.as_tensor(bits))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    with pytest.raises(ValueError, match="length"):
        tg.gf2_init(tm, [1, 0], device="cpu")
    with pytest.raises(ValueError, match="tap"):
        tg.make_scrambler((8,), 7)


@pytest.mark.parametrize("spec,want", [((0x1021, 16, 0xFFFF, 0, False), 0x29B1),
                                       (CRC32, 0xCBF43926)])
def test_crc_check_values(spec, want):
    jspec, tspec = _crc(spec)
    data = jg.bytes_to_bits(b"123456789", lsb_first=spec[4])
    np.testing.assert_array_equal(tg.bytes_to_bits(b"123456789", lsb_first=spec[4]), data)
    js = jg.crc_update(jspec, jg.crc_init(jspec), jnp.asarray(data))
    ts = tg.crc_update(tspec, tg.crc_init(tspec, device="cpu"), torch.as_tensor(data))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert int(tg.crc_value(tspec, ts)) == int(jg.crc_value(jspec, js)) == want


def test_crc32_batch_equals_binascii_and_jax():
    rng = np.random.default_rng(7)
    msgs = rng.integers(0, 256, (6, 223), dtype=np.uint8)
    jspec, tspec = _crc(CRC32)
    bits = tg.byte_tensor_bits(torch.as_tensor(msgs), lsb_first=True)
    np.testing.assert_array_equal(
        bits.numpy(), np.stack([jg.bytes_to_bits(m.tobytes(), lsb_first=True) for m in msgs]))
    ts = tg.crc_update(tspec, tg.crc_init(tspec, device="cpu"), bits)
    js = jg.crc_update(jspec, jnp.broadcast_to(jg.crc_init(jspec), (6, 32)), jnp.asarray(bits))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    vals = tg.crc_value(tspec, ts).numpy()
    np.testing.assert_array_equal(vals, np.asarray(jg.crc_value(jspec, js)).astype(np.int64))
    assert [int(v) for v in vals] == [binascii.crc32(m.tobytes()) for m in msgs]
    msb = tg.byte_tensor_bits(torch.as_tensor(msgs[:1]))
    np.testing.assert_array_equal(msb.numpy()[0], jg.bytes_to_bits(msgs[0].tobytes()))


def test_crc_register_carried_across_packages():
    """First 300 bytes in the JAX package, the rest in the port, equal to one
    call; the register goes back to numpy unchanged."""
    data = bytes(np.random.default_rng(1).integers(0, 256, 700, dtype=np.uint8))
    bits = jg.bytes_to_bits(data, lsb_first=True)
    jspec = _crc(CRC32)[0]
    tspec = convert.crc_spec_from(jspec)
    js = jg.crc_update(jspec, jg.crc_init(jspec), jnp.asarray(bits[:2400]))
    ts = convert.gf2_state_from(np.asarray(js), device="cpu")
    np.testing.assert_array_equal(convert.gf2_state_to_numpy(ts), np.asarray(js))
    ts = tg.crc_update(tspec, ts, torch.as_tensor(bits[2400:]))
    assert int(tg.crc_value(tspec, ts)) == binascii.crc32(data)
    js = jg.crc_update(jspec, js, jnp.asarray(bits[2400:]))
    np.testing.assert_array_equal(convert.gf2_state_to_numpy(ts), np.asarray(js))


def test_crc_width_refused():
    with pytest.raises(ValueError, match="width"):
        tg.make_crc(0x1, 33)
