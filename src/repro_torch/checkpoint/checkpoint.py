"""Atomic, async checkpointing (port of ``repro.checkpoint.checkpoint``).

Format, as the reference's: one directory per step, ``step_<N>/``:
    manifest.json   — leaf paths, shapes, dtypes, save metadata
    arrays.npz      — flat {index: array} of the leaves, as host arrays

  * **Atomic**: written to ``step_<N>.tmp`` and renamed; a crash mid-save
    never corrupts the latest checkpoint; ``latest_step`` only sees
    completed directories.
  * **Async**: ``save_async`` snapshots every leaf to host memory
    synchronously and writes on a background thread; ``wait()`` joins it
    (and raises what the writer raised) before the next save or exit.
    ``save`` copies and writes one leaf at a time, so it holds one leaf in
    host memory, not the whole state.
  * **GC**: keep the newest ``keep`` checkpoints.

A tree is a nest of dicts (keys in sorted order, as JAX flattens them),
lists and tuples over tensor (or numpy) leaves; an ``nn.Module`` stands
for the dict of its named parameters.  bf16 leaves are stored as a
``uint16`` bit view beside their dtype name (npz cannot hold bf16).
``restore`` writes into the tensors of a tree of the same structure, in
place, where the reference returns new host arrays: a model's training
state may be tens of GB and a second copy would not fit the card.  The
reference's ``checkpoint.save`` fault point comes with the fault harness
(ROADMAP queue 1, D1); restore onto other shardings with the mesh (E1).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zipfile
from typing import Any

import numpy as np
import torch
from torch import nn

# npz cannot store bf16: store a bit view and the dtype name.
_VIEW_AS = {"bfloat16": (np.uint16, torch.int16)}
_TORCH_DTYPES = {"bfloat16": torch.bfloat16}


def _flatten(tree, path: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) pairs in a fixed order."""
    if isinstance(tree, nn.Module):
        tree = dict(tree.named_parameters())
        return [(f"{path}[{k!r}]", v) for k, v in tree.items()]
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], f"{path}[{k!r}]")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, f"{path}[{i}]")
        return out
    if tree is None:
        return []
    return [(path, tree)]


def _to_host(leaf, copy: bool) -> tuple[np.ndarray, str]:
    """A leaf as a storable host array and its dtype name; with ``copy``,
    an array of its own even where the leaf already lies on the host
    (where it would otherwise share the leaf's storage)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=copy)
        name = str(t.dtype).removeprefix("torch.")
        if name in _VIEW_AS:
            np_view, torch_view = _VIEW_AS[name]
            return t.view(torch_view).numpy().view(np_view), name
        return t.numpy(), name
    a = np.array(leaf) if copy else np.asarray(leaf)
    return a, a.dtype.name


def _from_host(a: np.ndarray, name: str) -> torch.Tensor:
    if name in _VIEW_AS:
        _, torch_view = _VIEW_AS[name]
        return torch.from_numpy(a.view(np.int16)).view(_TORCH_DTYPES[name])
    return torch.from_numpy(a)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._err: list[BaseException] = []

    # ------------------------------------------------------------------
    def _steps(self) -> list[int]:
        return sorted(int(d.split("_")[1]) for d in os.listdir(self.dir)
                      if d.startswith("step_") and not d.endswith(".tmp"))

    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def wait(self):
        """Join the async writer; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err:
            err, self._err = self._err[0], []
            raise err

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any):
        """Synchronous save, one leaf in host memory at a time."""
        self.wait()
        flat = _flatten(tree)
        self._write(step, [p for p, _ in flat],
                    (_to_host(leaf, copy=False) for _, leaf in flat))

    def save_async(self, step: int, tree: Any):
        self.wait()
        # Snapshot to host memory NOW: the next step updates the tensors
        # in place, host tensors included.
        flat = _flatten(tree)
        host = [_to_host(leaf, copy=True) for _, leaf in flat]

        def work():
            try:
                self._write(step, [p for p, _ in flat], iter(host))
            except BaseException as e:  # repro: allow(overbroad-except)
                # the writer thread: wait() re-raises it in the caller
                self._err.append(e)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _write(self, step: int, paths, host_leaves):
        tmp = os.path.join(self.dir, f"step_{step}.tmp")
        final = os.path.join(self.dir, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        shapes, dtypes = [], []
        # The npz layout of np.savez, written entry by entry.
        with zipfile.ZipFile(os.path.join(tmp, "arrays.npz"), "w",
                             allowZip64=True) as zf:
            for i, (a, name) in enumerate(host_leaves):
                with zf.open(f"{i}.npy", "w", force_zip64=True) as f:
                    np.lib.format.write_array(f, a if a.flags.c_contiguous
                                              else a.copy(),
                                              allow_pickle=False)
                shapes.append(list(a.shape))
                dtypes.append(name)
        manifest = {"step": step, "paths": list(paths), "shapes": shapes,
                    "dtypes": dtypes}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        for s in self._steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"))

    # ------------------------------------------------------------------
    def restore(self, step: int, like: Any) -> Any:
        """Write checkpoint ``step`` into the leaves of ``like`` (a tree
        of the saved structure, shapes and dtypes), in place, one leaf at
        a time; returns ``like``."""
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        leaves = [leaf for _, leaf in _flatten(like)]
        if len(leaves) != len(manifest["dtypes"]):
            raise ValueError(f"checkpoint has {len(manifest['dtypes'])} "
                             f"leaves, expected {len(leaves)}")
        with np.load(os.path.join(path, "arrays.npz")) as z, \
                torch.no_grad():
            for i, leaf in enumerate(leaves):
                got = _from_host(z[str(i)], manifest["dtypes"][i])
                if isinstance(leaf, torch.Tensor):
                    if got.dtype != leaf.dtype or got.shape != leaf.shape:
                        raise ValueError(
                            f"{manifest['paths'][i]}: checkpoint holds "
                            f"{got.dtype} {tuple(got.shape)}, the tree "
                            f"{leaf.dtype} {tuple(leaf.shape)}")
                    leaf.copy_(got)
                else:
                    np.copyto(leaf, got.numpy())
        return like
