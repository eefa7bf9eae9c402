"""Checkpoint / resume for streaming chains (counterpart of
``srcdsp_tpu/checkpoint.py``).

The whole mutable universe of a running chain is one small tree of tensors
(overlap tails, NCO phase words, timing accumulators), so checkpointing is
exact: save the state plus the stream position every K blocks; resume =
load the state + seek the capture file to that block
(``io.capture.read_capture_blocks(start_block=...)``).

The file format is the reference's: ``<path>.npz`` holds ``leaf_0 ..
leaf_{n-1}`` in ``jax.tree_util``'s leaf order (``tree.flatten``) and
``block_index``; ``<path>.json`` holds ``block_index``, ``num_leaves``,
``treedef`` (advisory) and ``extra``. The format is shared both ways: a
checkpoint the JAX package wrote resumes here, and one written here resumes
on the JAX package. The port keeps u32 phase words in int64 tensors
(``ops/nco.py``); `save` stores each int64 leaf whose values all lie in
[0, 2^32) as uint32, the dtype the reference's states have at every such
leaf, and `restore` takes a uint32 or int32 leaf into an int64 example
exactly. An int64 leaf outside that range stays int64.

The multi-process form, `save_orbax` / `restore_orbax`, keeps the
reference's (state, block_index) contract over ``torch.distributed.
checkpoint``: each rank writes its own shards into one directory,
``<path>.dcp``, which restores on another number of processes. The JAX
package's orbax directory needs jax to read, so this directory is the
port's own format.
"""

from __future__ import annotations

import contextlib
import json
import os
import warnings
from typing import Any

import numpy as np
import torch

from srcdsp_tpu_torch import tree

#: stored integer dtypes an int64 example leaf takes exactly (the JAX
#: package's u32 phase words and int32 counters)
_INTO_INT64 = (np.dtype(np.uint32), np.dtype(np.int32))
_U32_MAX = (1 << 32) - 1


def _host_leaves(leaves) -> list[np.ndarray]:
    """Every leaf as numpy, in one pass: each card tensor's copy is queued
    without a wait, then each card is synchronized once."""
    staged, cards = [], set()
    for x in leaves:
        if isinstance(x, torch.Tensor):
            x = x.detach()
            if x.device.type == "cuda":
                cards.add(x.device)
                x = x.to("cpu", non_blocking=True)
        staged.append(x)
    for d in cards:
        torch.cuda.synchronize(d)
    return [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x) for x in staged]


def _as_stored(a: np.ndarray) -> np.ndarray:
    """An int64 leaf with every value in [0, 2^32) as uint32 (the reference's
    phase-word dtype); any other leaf as it is."""
    if a.dtype == np.int64 and (a.size == 0 or (a.min() >= 0 and a.max() <= _U32_MAX)):
        return a.astype(np.uint32)
    return a


def save(path: str, state: Any, block_index: int, extra: dict | None = None) -> None:
    """Save a chain state + stream position. Overwrites `path`(.npz).

    Atomic: block_index travels INSIDE the .npz (one os.replace commits state
    and position together), and the .json sidecar is also replaced
    atomically; a crash at any point leaves either the old checkpoint or the
    new one, never a state/position mismatch. Phase words are stored as
    uint32 (`_as_stored`), so the JAX package restores the file too.
    """
    leaves, treedef = tree.flatten(state)
    arrays = {f"leaf_{i}": _as_stored(a) for i, a in enumerate(_host_leaves(leaves))}
    arrays["block_index"] = np.asarray(int(block_index))
    meta = {
        "block_index": int(block_index),
        "num_leaves": len(leaves),
        "treedef": str(treedef),
        "extra": extra or {},
    }
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path + ".npz")
    tmpj = path + ".tmp.json"
    with open(tmpj, "w") as f:
        json.dump(meta, f)
    os.replace(tmpj, path + ".json")


def _np_dtype(x) -> np.dtype:
    if isinstance(x, torch.Tensor):
        return torch.empty((), dtype=x.dtype).numpy().dtype
    return np.asarray(x).dtype


def _restore_leaf(i: int, arr: np.ndarray, ex) -> Any:
    """`arr` as the example leaf `ex`: same shape, same dtype (or a u32 /
    int32 array into an int64 example: every such value fits, so the cast is
    exact), a tensor on ex's device where ex is one."""
    shape = tuple(ex.shape) if isinstance(ex, torch.Tensor) else np.shape(ex)
    dtype = _np_dtype(ex)
    if arr.shape != shape or not (arr.dtype == dtype or (
            dtype == np.int64 and arr.dtype in _INTO_INT64)):
        raise ValueError(f"leaf {i}: checkpoint {arr.shape}/{arr.dtype} vs "
                         f"expected {shape}/{dtype}")
    arr = arr.astype(dtype, copy=False)
    return torch.as_tensor(arr, device=ex.device) if isinstance(ex, torch.Tensor) else arr


def restore(path: str, example_state: Any) -> tuple[Any, int]:
    """Load (state, block_index). `example_state` supplies the tree structure
    and the device of each leaf; its leaf VALUES are ignored. Raises
    ValueError on a different leaf count, shape or dtype."""
    with open(path + ".json") as f:
        meta = json.load(f)
    data = np.load(path + ".npz")
    # the position inside the .npz is authoritative (committed atomically
    # with the state); the .json value is advisory for humans
    if "block_index" in data:
        meta["block_index"] = int(data["block_index"])
    leaves, treedef = tree.flatten(example_state)
    if meta["num_leaves"] != len(leaves):
        raise ValueError(
            f"checkpoint has {meta['num_leaves']} leaves, expected {len(leaves)}")
    new_leaves = [_restore_leaf(i, data[f"leaf_{i}"], ex) for i, ex in enumerate(leaves)]
    return tree.unflatten(treedef, new_leaves), int(meta["block_index"])


def exists(path: str) -> bool:
    return os.path.exists(path + ".npz") and os.path.exists(path + ".json")


def delete(path: str) -> None:
    """Invalidate a checkpoint (call when the stream completes)."""
    for suffix in (".npz", ".json"):
        try:
            os.remove(path + suffix)
        except FileNotFoundError:
            pass


# --- the multi-process form: (state, block_index) over torch.distributed.checkpoint


def _dcp_dir(path: str) -> str:
    return os.path.abspath(path) + ".dcp"


def _keyed(state: Any, spec) -> tuple[dict, list]:
    """{key: tensor} of a state (replicated) or of this rank's shard states
    (`spec` a ``dist.mesh.Sharding``: `state` is one tree per held index),
    and for each tree its definition and keys, to rebuild it."""
    trees = [state] if spec is None else list(state)
    if spec is not None and len(trees) != len(spec.indices):
        raise ValueError(f"{len(trees)} shard states for indices {spec.indices}")
    out, defs = {}, []
    for j, st in enumerate(trees):
        leaves, treedef = tree.flatten(st)
        head = "state" if spec is None else f"shard_{spec.indices[j]}"
        keys = [f"{head}/leaf_{i}" for i in range(len(leaves))]
        for i, (k, x) in enumerate(zip(keys, leaves)):
            if not isinstance(x, torch.Tensor):
                raise TypeError(f"leaf {i} is {type(x).__name__}; save_orbax stores tensors")
            out[k] = x
        defs.append((treedef, keys))
    return out, defs


@contextlib.contextmanager
def _one_process(grouped: bool):
    """Outside a process group DCP warns that it assumes one process, which
    is what `no_dist` asks for: silence that one warning."""
    with warnings.catch_warnings():
        if not grouped:
            warnings.filterwarnings("ignore", message="torch.distributed is disabled")
        yield


def save_orbax(path: str, state: Any, block_index: int, sharding=None) -> None:
    """Save (state, block_index) into the directory ``<path>.dcp`` with
    ``torch.distributed.checkpoint``: the reference's multi-host contract,
    in the port's own format (the reference's orbax directory needs jax).

    A replicated `state` is written once. With `sharding`
    (``dist.mesh.time_sharding`` / ``channel_sharding``), `state` is a tuple
    of this rank's shard states, one per index the sharding holds, and each
    rank writes its own, keyed by global shard index, so the directory
    restores on any number of processes. Every rank of the group calls it;
    the new directory replaces the old one only once every rank has written.
    """
    import shutil

    import torch.distributed.checkpoint as dcp

    from srcdsp_tpu_torch.dist import comm

    final = _dcp_dir(path)
    tmp, old = final + ".tmp", final + ".old"
    if comm.rank() == 0:
        shutil.rmtree(tmp, ignore_errors=True)
    if comm.active():
        torch.distributed.barrier()
    sd, _ = _keyed(state, sharding)
    sd["block_index"] = torch.tensor(int(block_index), dtype=torch.int64)
    with _one_process(comm.active()):
        dcp.save(sd, storage_writer=dcp.FileSystemWriter(tmp), no_dist=not comm.active())
    if comm.rank() == 0:
        shutil.rmtree(old, ignore_errors=True)
        if os.path.exists(final):
            os.replace(final, old)
        os.replace(tmp, final)
        shutil.rmtree(old, ignore_errors=True)
    if comm.active():
        torch.distributed.barrier()


def restore_orbax(path: str, example_state: Any, sharding=None) -> tuple[Any, int]:
    """Load (state, block_index) from ``<path>.dcp``. `example_state` gives
    the structure, shapes, dtypes and devices (its values are ignored); with
    `sharding`, it is a tuple of example shard states for the indices this
    rank holds, which may differ from the ranks and shards that saved.
    Every rank of the group calls it."""
    import torch.distributed.checkpoint as dcp

    from srcdsp_tpu_torch.dist import comm

    ex, defs = _keyed(example_state, sharding)
    sd = {k: torch.empty_like(v) for k, v in ex.items()}
    sd["block_index"] = torch.zeros((), dtype=torch.int64)
    with _one_process(comm.active()):
        dcp.load(sd, storage_reader=dcp.FileSystemReader(_dcp_dir(path)),
                 no_dist=not comm.active())
    trees = [tree.unflatten(treedef, [sd[k] for k in keys]) for treedef, keys in defs]
    return (trees[0] if sharding is None else tuple(trees)), int(sd["block_index"])
