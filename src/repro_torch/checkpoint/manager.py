"""Manifest checkpoints with atomic publish and an async writer: the port
of `repro.checkpoint.manager`, in the reference's format on disk, so
either package reads what the other wrote.

Layout::

    <dir>/step_000000123.tmp/       # staged
        manifest.json               # step, treedef, n_leaves, meta, leaves
        leaf_00000.npy ...          # one file per tree leaf
    <dir>/step_000000123/           # atomic rename on completion

Leaves go in `jax.tree_util.tree_flatten`'s order (`_tree.flatten`: dict
keys sorted, tuples and NamedTuple fields in order), each as one ``.npy``
of its values; a leaf of a type NumPy does not hold natively (bfloat16,
the float8 types) is stored as its raw bytes (uint8) under the dtype's
name, with ``"raw": true`` in its manifest entry.  A crash mid-write never
corrupts the latest checkpoint: `latest_step` and `restore` read only
published directories.  `restore(..., like=)` builds the tree of
``like``, each leaf a tensor of ``like``'s leaf's dtype on its device.
`AsyncCheckpointer` copies the
tree to the host when a save is submitted and writes it on a worker
thread.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .. import _tree

PyTree = Any

# dtypes np.save holds as they are; any other leaf is stored as raw bytes
NATIVE = ("float64", "float32", "float16", "int64", "int32", "int16",
          "int8", "uint64", "uint32", "uint16", "uint8", "bool")


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).split(".")[-1]
    return str(np.asarray(leaf).dtype)


def _host(leaf):
    """A leaf as a host value that later writes to the original cannot
    change: a CPU tensor (cloned if it already was on the CPU) or a numpy
    array."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        return t.clone() if t.device.type == "cpu" else t.cpu()
    return np.array(leaf)


def _to_numpy(leaf) -> Tuple[np.ndarray, str, bool]:
    """(the array np.save writes, the leaf's dtype name, raw)."""
    name = _dtype_name(leaf)
    raw = name not in NATIVE
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        arr = (t.reshape(-1).view(torch.uint8).numpy() if raw
               else t.numpy())
    else:
        arr = np.asarray(leaf)
        if raw:
            arr = np.frombuffer(arr.tobytes(), np.uint8)
    return arr, name, raw


def save(directory: str, step: int, tree: PyTree,
         meta: Optional[Dict[str, Any]] = None) -> str:
    """Write ``tree`` as step ``step``: staged in ``step_XXXXXXXXX.tmp``,
    then published by an atomic `os.replace`.  Returns the published
    directory."""
    os.makedirs(directory, exist_ok=True)
    name = f"step_{step:09d}"
    tmp = os.path.join(directory, name + ".tmp")
    final = os.path.join(directory, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves, treedef = _tree.flatten(tree)
    manifest = {"step": step, "treedef": str(treedef),
                "n_leaves": len(leaves), "meta": meta or {}, "leaves": []}
    for i, leaf in enumerate(leaves):
        arr, dtype, raw = _to_numpy(leaf)
        fn = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fn), arr)
        manifest["leaves"].append(
            {"file": fn, "shape": list(np.shape(leaf)), "dtype": dtype,
             "raw": raw})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)              # atomic publish
    return final


def _published(directory: str):
    return [int(d.split("_")[1]) for d in os.listdir(directory)
            if d.startswith("step_") and not d.endswith(".tmp")]


def latest_step(directory: str) -> Optional[int]:
    """The newest published step with a manifest, or None."""
    if not os.path.isdir(directory):
        return None
    steps = [s for s in _published(directory)
             if os.path.exists(os.path.join(directory, f"step_{s:09d}",
                                            "manifest.json"))]
    return max(steps) if steps else None


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"checkpoint leaf of unknown dtype {name!r}")
    return dt


def _load_leaf(path: str, spec: Dict[str, Any]) -> torch.Tensor:
    arr = np.load(os.path.join(path, spec["file"]))
    if not spec.get("raw"):
        return torch.from_numpy(np.array(arr, order="C"))
    raw = torch.frombuffer(bytearray(arr.tobytes()), dtype=torch.uint8)
    return raw.view(_torch_dtype(spec["dtype"])).reshape(spec["shape"])


def restore(directory: str, step: int, like: PyTree
            ) -> Tuple[PyTree, Dict[str, Any]]:
    """(the tree of ``like`` read from step ``step``, the saved meta).  A
    leaf takes ``like``'s leaf's dtype (cast if the file's differs) and
    device — a leaf of ``like`` that is no tensor gives a CPU tensor of
    the file's dtype; a shape or leaf-count mismatch raises."""
    path = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves_like, treedef = _tree.flatten(like)
    if len(leaves_like) != manifest["n_leaves"]:
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, expected "
            f"{len(leaves_like)} — incompatible tree")
    out = []
    for i, (spec, want) in enumerate(zip(manifest["leaves"], leaves_like)):
        t = _load_leaf(path, spec)
        if tuple(t.shape) != tuple(np.shape(want)):
            raise ValueError(f"leaf {i}: shape {tuple(t.shape)} != "
                             f"expected {tuple(np.shape(want))}")
        out.append(t.to(device=want.device, dtype=want.dtype)
                   if isinstance(want, torch.Tensor) else t)
    return _tree.unflatten(treedef, out), manifest["meta"]


def rotate(directory: str, keep: int = 3) -> None:
    """Delete all but the newest ``keep`` published steps."""
    if not os.path.isdir(directory):
        return
    for s in sorted(_published(directory))[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:09d}"),
                      ignore_errors=True)


class AsyncCheckpointer:
    """Serialize checkpoints on a worker thread; `wait()` drains before
    exit or preemption.  Keeps at most one pending save."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self.q: "queue.Queue" = queue.Queue(maxsize=1)
        self.errors: list = []
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self.q.get()
            if item is None:
                return
            step, tree, meta = item
            try:
                save(self.directory, step, tree, meta)
                rotate(self.directory, self.keep)
            except Exception as e:  # noqa: BLE001 — surfaced via .errors
                self.errors.append(e)

    def submit(self, step: int, tree: PyTree,
               meta: Optional[Dict[str, Any]] = None):
        """Queue a save of ``tree``, copied to the host now, so the trainer
        may go on with (or overwrite) its tensors."""
        self.q.put((step, _tree.tree_map(_host, tree), meta))

    def wait(self):
        """Drain pending saves and stop the worker (call before exit or on
        a preemption signal); raises the first error a save met."""
        self.q.put(None)
        self._thread.join()
        if self.errors:
            raise self.errors[0]
