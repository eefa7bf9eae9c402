"""Port vs JAX package: a capture streamed straight onto a time-sharded mesh
(``io.capture.device_blocks(..., sharding=...)``) and through K20.

The reference lands each block with ``jax.device_put(block, NamedSharding(
mesh, P(None, "time")))`` on conftest's 8 virtual CPU devices; the port's
shards on ``make_mesh(time=8, devices=["cpu"] * 8)`` must equal its
addressable shards (``np.array_equal``), for ci16 and cf32, planes and
complex samples, from a later start block too, and equal ``dist.mesh.shard``
of the port's unsharded block in every wire format. On a mesh across
processes (laid out here without processes) a rank gets only its own shards.

The streamed path: 3 blocks of a ci16 capture through the plain K20 on 4 CPU
shards (``multihost_check.stream_k20``, the tail and the phase word carried),
against the JAX package's ``mix_fir_halo_sharded`` (Pallas interpret mode,
4 virtual devices) fed the same sharded blocks: shards and carried tails
bit-equal, outputs within K20's port-vs-JAX tolerance (rel L2 < 1e-5: float32
sums in another order, ``tests/test_torch_halo_kernels.py``), and equal by
``torch.equal`` to the port's unsharded stream (K1 on ``[tail | block]``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from srcdsp_tpu import dist as jdist
from srcdsp_tpu.io.capture import device_blocks as j_device_blocks
from srcdsp_tpu.kernels.halo_fused import make_halo_fused_kernel as j_make_k20
from srcdsp_tpu.kernels.halo_fused import mix_fir_halo_sharded as j_k20_sharded
from srcdsp_tpu_torch.dist import mesh as tdm
from srcdsp_tpu_torch.dist import multihost_check as mhc
from srcdsp_tpu_torch.io import capture
from srcdsp_tpu_torch.kernels import halo_fused as k20
from srcdsp_tpu_torch.kernels.mixfir import make_mix_fir_kernel
from srcdsp_tpu_torch.ops.nco import freq_to_word
from srcdsp_tpu_torch.ops.window import lowpass
from tests.torch_threads import one_torch_thread  # noqa: F401

MASK32 = (1 << 32) - 1


def _capture(tmp_path, fmt: str, n: int = 1000, seed: int = 0) -> str:
    rng = np.random.default_rng(seed)
    x = (0.4 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)
    path = str(tmp_path / f"x.{fmt}")
    capture.write_capture(path, x, capture.CaptureMeta(fmt=fmt))
    return path


def _rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _in_mesh_order(arr) -> list[np.ndarray]:
    """A jax.Array's addressable shards as numpy, ordered by time offset."""
    shards = sorted(arr.addressable_shards, key=lambda s: s.index[-1].start or 0)
    return [np.asarray(s.data) for s in shards]


@pytest.mark.parametrize("planes", [True, False], ids=["planes", "complex"])
@pytest.mark.parametrize("fmt", ["ci16", "cf32"])
def test_sharded_blocks_equal_the_reference_addressable_shards(tmp_path, fmt, planes):
    path = _capture(tmp_path, fmt)
    ndim = 2 if planes else 1
    mesh = tdm.make_mesh(time=8, devices=["cpu"] * 8)
    capture.reset_h2d()
    got = list(capture.device_blocks(path, 256, start_block=1, planes=planes,
                                     sharding=tdm.time_sharding(mesh, ndim)))
    jmesh = jdist.make_mesh(time=8)
    spec = P(None, "time") if planes else P("time")
    ref = list(j_device_blocks(path, 256, start_block=1, sharding=NamedSharding(jmesh, spec),
                               planes=planes))
    whole = list(capture.device_blocks(path, 256, start_block=1, planes=planes, device="cpu"))
    assert len(got) == len(ref) == len(whole) == 2
    for shards, jarr, xb in zip(got, ref, whole):
        assert len(shards) == 8
        for s, r in zip(shards, _in_mesh_order(jarr)):
            assert s.device.type == "cpu" and tuple(s.shape) == r.shape
            np.testing.assert_array_equal(s.numpy(), r)
        assert all(torch.equal(a, b) for a, b in zip(shards, tdm.shard(xb, mesh)))
    # one copy a shard a block in the sharded pass, then one a block unsharded
    assert capture.H2D["cpu"]["copies"] == 2 * 8 + 2
    assert capture.H2D["cpu"]["bytes"] == 2 * 2 * 256 * 8


@pytest.mark.parametrize("fmt", ["cu8", "ci8"])
def test_sharded_blocks_in_every_wire_format(tmp_path, fmt):
    path = _capture(tmp_path, fmt, seed=1)
    mesh = tdm.make_mesh(time=4, devices=["cpu"] * 4)
    for planes in (True, False):
        got = capture.device_blocks(path, 128, planes=planes,
                                    sharding=tdm.time_sharding(mesh, 2 if planes else 1))
        for shards, xb in zip(got, capture.device_blocks(path, 128, planes=planes,
                                                         device="cpu")):
            assert all(torch.equal(a, b) for a, b in zip(shards, tdm.shard(xb, mesh)))


def test_a_rank_of_a_multiprocess_mesh_gets_only_its_shards(tmp_path):
    path = _capture(tmp_path, "ci16", seed=2)
    jmesh = jdist.make_mesh(time=8)
    ref = next(j_device_blocks(path, 256, sharding=NamedSharding(jmesh, P(None, "time")),
                               planes=True))
    for rank in (0, 1):
        mesh = tdm.layout(8, 1, [["cpu"] * 4] * 2, rank)
        spec = tdm.time_sharding(mesh, 2)
        shards = next(capture.device_blocks(path, 256, planes=True, sharding=spec))
        assert spec.indices == tuple(range(4 * rank, 4 * rank + 4)) and len(shards) == 4
        for s, r in zip(shards, _in_mesh_order(ref)[4 * rank:]):
            np.testing.assert_array_equal(s.numpy(), r)


def test_device_blocks_refuses_what_it_cannot_place(tmp_path):
    path = _capture(tmp_path, "ci16", seed=3)
    mesh = tdm.make_mesh(time=8, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="does not split over 8 shards"):
        capture.device_blocks(path, 250, planes=True, sharding=tdm.time_sharding(mesh, 2))
    grid = tdm.make_mesh(time=2, channel=2, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="one channel"):
        capture.device_blocks(path, 256, sharding=tdm.channel_sharding(grid, 1))
    with pytest.raises(ValueError, match="one channel"):
        capture.device_blocks(path, 256, planes=True, sharding=tdm.channel_sharding(grid, 2))
    with pytest.raises(ValueError, match="one channel"):       # planes cut along dim 0
        capture.device_blocks(path, 256, planes=True, sharding=tdm.time_sharding(mesh, 1))
    with pytest.raises(ValueError, match="not both"):
        capture.device_blocks(path, 256, device="cpu", sharding=tdm.time_sharding(mesh, 1))


def test_device_blocks_on_a_card_mesh_raises_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = _capture(tmp_path, "ci16", seed=4)
    mesh = tdm.Mesh(tuple((torch.device("cuda", 0),) for _ in range(4)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        capture.device_blocks(path, 256, planes=True, sharding=tdm.time_sharding(mesh, 2))


def test_capture_streamed_onto_the_mesh_through_k20_matches_jax_and_the_unsharded_stream(
        tmp_path):
    taps, decim, p, blocks = lowpass(64, 0.2), 2, 4, 3
    kf = k20.make_halo_fused_kernel(taps, decim, out_tile=128, b_rows=2, device="cpu")
    k1 = make_mix_fir_kernel(taps, decim, out_tile=128, b_rows=2, device="cpu")
    jkf = j_make_k20(taps, decim, out_tile=128, b_rows=2, interpret=True)
    block, word, hist = p * kf.block_in(), int(freq_to_word(0.11)), kf.hist
    path = _capture(tmp_path, "ci16", n=blocks * block, seed=5)
    mesh = tdm.make_mesh(time=p, devices=["cpu"] * p)
    tail, ys = mhc.stream_k20(kf, word, path, block, mesh)
    assert len(ys) == blocks
    # the JAX package's K20 on the reference's sharded blocks of the same file
    jmesh = jdist.make_mesh(time=p)
    jtail = jnp.zeros((2, hist), jnp.float32)
    jblocks = j_device_blocks(path, block, sharding=NamedSharding(jmesh, P(None, "time")),
                              planes=True)
    # the port's unsharded stream: K1 on [tail | block]
    ktail = torch.zeros((2, hist))
    for b, (jx, xb, y) in enumerate(zip(jblocks, capture.device_blocks(
            path, block, planes=True, device="cpu"), ys)):
        w0 = (b * block * word) & MASK32
        jtail, jy = j_k20_sharded(jkf, w0, word, jtail, jx, jmesh)
        got = tdm.unshard(y, "cpu")
        assert _rel(got.numpy(), np.asarray(jy)) < 1e-5
        rr, ri = k1.fn((w0 - hist * word) & MASK32, word, torch.cat([ktail, xb], dim=-1))
        assert torch.equal(got, torch.stack([rr.reshape(-1), ri.reshape(-1)]))
        ktail = xb[:, -hist:]
    np.testing.assert_array_equal(tail.numpy(), np.asarray(jtail))
    assert torch.equal(tail, ktail)
    # from a later block, with that block's carried tail and word: the same outputs
    tail2, ys2 = mhc.stream_k20(kf, word, path, block, mesh, start_block=1)
    assert torch.equal(tail2, tail)
    # block 1 starts from rest here, so only block 2 (after one join) must agree
    assert all(torch.equal(a, b) for a, b in zip(ys2[1], ys[2]))
