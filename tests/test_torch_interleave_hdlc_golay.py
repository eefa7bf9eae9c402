"""Port vs JAX package: interleavers (``interleave``), HDLC framing
(``hdlc``) and the extended Golay code (``golay``), bit for bit.

- block interleave and deinterleave, permutation and its inverse (the same
  numpy permutation), for bits, floats and complex symbols;
- the convolutional interleaver's delay lines after every block, a state
  handed over from the JAX package mid-stream (`convert.
  conv_interleaver_state_from`, `conv_interleaver_state_to_numpy`), and the
  cascade restoring the stream after B(B-1)M symbols;
- `stuff_bits` / `destuff_bits` (values, masks, carried runs) with runs
  carried in, blocks streamed, `find_flags`, the compact round trip;
- Golay tables, encoding, decoding at 0-3 errors (corrected) and at 4
  (every word flagged).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcdsp_tpu import golay as jgo
from srcdsp_tpu import hdlc as jh
from srcdsp_tpu import interleave as ji
from srcdsp_tpu_torch import convert
from srcdsp_tpu_torch import golay as tgo
from srcdsp_tpu_torch import hdlc as th
from srcdsp_tpu_torch import interleave as ti
from tests.torch_threads import one_torch_thread  # noqa: F401


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy() if isinstance(got, torch.Tensor) else got,
                                  np.asarray(want))


@pytest.mark.parametrize("dtype", [np.int32, np.float32, np.complex64])
@pytest.mark.parametrize("rows,cols,frames", [(4, 255, 2), (3, 5, 4), (1, 7, 1)])
def test_block_interleave_equal(dtype, rows, cols, frames):
    rng = np.random.default_rng(rows * cols)
    x = (rng.standard_normal((2, frames * rows * cols)) * 100).astype(dtype)
    y = ti.block_interleave(torch.as_tensor(x), rows, cols)
    _eq(y, ji.block_interleave(jnp.asarray(x), rows, cols))
    _eq(ti.block_deinterleave(y, rows, cols), x)
    with pytest.raises(ValueError, match="multiple"):
        ti.block_interleave(torch.as_tensor(x[:, 1:]), rows + 1, cols)


def test_permutation_equal():
    perm = ti.random_permutation(40, seed=5)
    _eq(perm, ji.random_permutation(40, seed=5))
    x = np.random.default_rng(0).standard_normal((3, 120)).astype(np.float32)
    _eq(ti.permute(torch.as_tensor(x), perm), ji.permute(jnp.asarray(x), perm))
    _eq(ti.depermute(torch.as_tensor(x), perm), ji.depermute(jnp.asarray(x), perm))
    _eq(ti.depermute(ti.permute(torch.as_tensor(x), perm), perm), x)


@pytest.mark.parametrize("branches,depth", [(4, 3), (12, 17), (2, 1)])
def test_conv_interleaver_state_across_blocks(branches, depth):
    rng = np.random.default_rng(branches)
    n = branches * 6
    js = ji.conv_interleave_init(branches, depth, (2,))
    ts = ti.conv_interleave_init(branches, depth, (2,), device="cpu")
    jd = ji.conv_deinterleave_init(branches, depth, (2,))
    td = ti.conv_deinterleave_init(branches, depth, (2,), device="cpu")
    sent, got = [], []
    for blk in range(12):
        x = rng.standard_normal((2, n)).astype(np.float32)
        if blk == 5:   # hand the JAX states over mid-stream
            ts = convert.conv_interleaver_state_from(js, device="cpu")
            td = convert.conv_interleaver_state_from(jd, device="cpu")
        js, jy = ji.conv_interleave(js, jnp.asarray(x))
        ts, ty = ti.conv_interleave(ts, torch.as_tensor(x))
        _eq(ty, jy)
        for want, line in zip(js.lines, convert.conv_interleaver_state_to_numpy(ts)):
            _eq(line, want)
        jd, jz = ji.conv_deinterleave(jd, jy)
        td, tz = ti.conv_deinterleave(td, ty)
        _eq(tz, jz)
        sent.append(x)
        got.append(tz.numpy())
    delay = ti.conv_total_delay(branches, depth)
    assert delay == ji.conv_total_delay(branches, depth)
    sent, got = np.concatenate(sent, -1), np.concatenate(got, -1)
    np.testing.assert_array_equal(got[:, delay:], sent[:, : sent.shape[-1] - delay])


def test_conv_interleaver_refuses_ragged_block():
    s = ti.conv_interleave_init(4, 2, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        ti.conv_interleave(s, torch.zeros(10))


# jitted: the eager associative_scan costs seconds a call
J_HDLC = (jax.jit(jh.stuff_bits), jax.jit(jh.destuff_bits), jax.jit(jh.find_flags))


def _hdlc_bits(n, seed):
    return (np.random.default_rng(seed).random(n) < 0.85).astype(np.int32)


@pytest.mark.parametrize("n", [5, 64, 333, 4096])
@pytest.mark.parametrize("run0", [0, 2, 4])
def test_stuff_destuff_equal(n, run0):
    b = _hdlc_bits(n, n + run0)
    for jf, tf in ((J_HDLC[0], th.stuff_bits), (J_HDLC[1], th.destuff_bits)):
        for got, want in zip(tf(torch.as_tensor(b), run0), jf(jnp.asarray(b), run0)):
            _eq(got, want)
    _eq(th.find_flags(torch.as_tensor(b)), J_HDLC[2](jnp.asarray(b)))


def test_hdlc_streamed_round_trip_and_flags():
    """Stuff in 3 blocks with the run carried, frame with flags, find the
    flags, destuff in other blocks: the payload comes back."""
    b = _hdlc_bits(3000, 1)
    parts, run = [], 0
    for blk in np.split(b, [1000, 2001]):
        out, valid, run = th.stuff_bits(torch.as_tensor(blk), run)
        parts.append(th.compact_bits(out, valid))
    stuffed = np.concatenate(parts)
    one, ok1, _ = th.stuff_bits(torch.as_tensor(b))
    np.testing.assert_array_equal(stuffed, th.compact_bits(one, ok1))
    frame = np.concatenate([th.FLAG, stuffed, th.FLAG])
    flags = np.nonzero(th.find_flags(torch.as_tensor(frame)).numpy())[0]
    np.testing.assert_array_equal(flags, [0, frame.size - 8])
    body = frame[8:-8]
    parts, run = [], 0
    for blk in np.split(body, [777, 2500]):
        vals, valid, run = th.destuff_bits(torch.as_tensor(blk), run)
        parts.append(th.compact_bits(vals, valid))
    np.testing.assert_array_equal(np.concatenate(parts), b)
    assert th.find_flags(torch.ones(5, dtype=torch.int32)).numpy().tolist() == [False] * 5


def test_golay_tables_equal():
    jc, tc = jgo.make_golay(), tgo.make_golay()
    for f in jc._fields:
        _eq(getattr(tc, f), getattr(jc, f))
    conv = convert.golay_from(jc)
    for f in jc._fields:
        _eq(getattr(conv, f), getattr(jc, f))


@pytest.mark.parametrize("nerr", [0, 1, 2, 3, 4])
def test_golay_decode_equal(nerr):
    jc, tc = jgo.make_golay(), tgo.make_golay()
    rng = np.random.default_rng(nerr)
    data = rng.integers(0, 2, (300, 12))
    cw = tgo.golay_encode(tc, torch.as_tensor(data))
    _eq(cw, jgo.golay_encode(jc, jnp.asarray(data)))
    recv = cw.numpy().copy()
    for row in recv:
        row[rng.choice(24, nerr, replace=False)] ^= 1
    got = tgo.golay_decode(tc, torch.as_tensor(recv))
    for g, w in zip(got, jgo.golay_decode(jc, jnp.asarray(recv))):
        _eq(g, w)
    if nerr <= 3:
        _eq(got[0], data)
        assert bool(got[2].all()) and bool((got[1] == nerr).all())
    else:
        assert not bool(got[2].any())
