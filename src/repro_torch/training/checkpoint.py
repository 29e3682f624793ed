"""Checkpoints: atomic, in the reference's on-disk format (the counterpart
of ``repro.training.checkpoint``).

One directory a step, ``step_XXXXXXXX/``, holding ``arrays.npz`` (flat key
-> numpy array) and ``manifest.json`` (``{"step", "keys"}``).  A write goes
to ``step_XXXXXXXX.tmp`` and is renamed when complete, so a crash mid-write
never corrupts the newest checkpoint; ``latest_step`` skips ``.tmp``
directories and directories without a manifest.

Flat keys are the reference's: dict keys joined by ``/``.  A list (a layer
stack, see :mod:`repro_torch.training.tree`) is written as ONE array with
a leading ``L`` axis, as the reference's stacked leaves are, so a
checkpoint of ``{"params": ..., "opt": ...}`` written by either package
restores in the other: ColBERTv2's training state and an LM's (its
``embed``, ``lm_head``, ``final_norm``, ``dense_layers`` / ``moe_layers``
stacks, the moments, ``step`` and, with int8, ``ef``).  Tensors are copied to the host before the write.

``CheckpointManager`` keeps the last ``keep`` checkpoints and can write on
a daemon thread (a queue of host arrays; the train loop does not wait on
the disk).  A checkpoint holds one replica's values, so one written at any
world size restores at any other: ``restore(shardings=)`` places it on
this process's devices (``distributed.sharding.tree_shardings``).  On a
mesh with a ``"model"`` axis above 1 the same holds for the reference's
whole leaves: :func:`gather` gathers each split leaf over ``"model"``
before one process saves, and ``restore(shardings=)`` cuts this
process's piece from each whole leaf, so a checkpoint crosses between a
model mesh, one process and the reference.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading

import numpy as np

from repro_torch.training import tree as T

_SEP = "/"


def _flatten(tree, prefix: str = "", out: dict | None = None) -> dict:
    """A numpy tree (:func:`tree.to_numpy`'s) as ``{"a/b/c": array}``; a
    list of subtrees keys its elements "0", "1", ..."""
    out = {} if out is None else out
    if isinstance(tree, (dict, list)):
        items = sorted(tree.items()) if isinstance(tree, dict) else enumerate(tree)
        for k, v in items:
            _flatten(v, f"{prefix}{_SEP}{k}" if prefix else str(k), out)
    else:
        out[prefix] = tree
    return out


def _nest(flat: dict) -> dict:
    """The inverse of :func:`_flatten`."""
    tree: dict = {}
    for key, arr in flat.items():
        *path, last = key.split(_SEP)
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[last] = arr
    return tree


def gather(tree, shardings=None):
    """``tree`` with every leaf that ``shardings`` splits over ``"model"``
    gathered whole (``distributed.sharding.gather_tree``; a collective:
    every process of the model group calls it); ``tree`` itself when
    ``shardings`` is None."""
    if shardings is None:
        return tree
    from repro_torch.distributed import sharding

    return sharding.gather_tree(tree, shardings)


def save(ckpt_dir: str, step: int, tree) -> str:
    """Atomic checkpoint write; returns the final path.  A tree of a model
    mesh's pieces is gathered first (:func:`gather`, on every process)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = _flatten(T.to_numpy(tree))
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "keys": sorted(flat)}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _complete_steps(ckpt_dir: str) -> list[int]:
    return sorted(
        int(name.split("_")[1]) for name in os.listdir(ckpt_dir)
        if name.startswith("step_") and not name.endswith(".tmp")
        and os.path.exists(os.path.join(ckpt_dir, name, "manifest.json"))
    )


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _complete_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, template, step: int | None = None, shardings=None):
    """The checkpoint at ``step`` (the newest when None) in ``template``'s
    structure: a tensor leaf comes back as a tensor on that leaf's device,
    a list as one tensor a layer, anything else as numpy.  ``shardings``
    (a device, or a tree of devices or ``sharding.Placement`` objects in
    ``template``'s shape) places every leaf anew (elastic re-mesh), a
    placement's leaf cut to this process's piece.  Returns ``(tree,
    step)``."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "arrays.npz")
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    if shardings is None:
        return T.from_numpy(_nest(flat), template), step
    from repro_torch.distributed import sharding

    host = T.from_numpy(_nest(flat), T.tree_map(lambda _: None, template))
    return sharding.place_tree(host, shardings), step


class CheckpointManager:
    """Rolling checkpoints with optional asynchronous writes."""

    def __init__(self, ckpt_dir: str, keep: int = 3, async_write: bool = True):
        self.dir = ckpt_dir
        self.keep = keep
        self.async_write = async_write
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self._err: Exception | None = None
        if async_write:
            self._thread = threading.Thread(target=self._drain, daemon=True)
            self._thread.start()

    def _drain(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, host_tree = item
            try:
                save(self.dir, step, host_tree)
                self._gc()
            except Exception as e:  # surfaced on the next save()
                self._err = e

    def _gc(self):
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.dir)
            if n.startswith("step_") and not n.endswith(".tmp")
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"))

    def save(self, step: int, tree):
        if self._err:
            raise self._err
        host = T.to_numpy(tree)  # device -> host copy (waits for the device)
        if self.async_write:
            self._q.put((step, host))
        else:
            save(self.dir, step, host)
            self._gc()

    def wait(self):
        """Flush pending writes and stop the writer thread."""
        if self.async_write:
            self._q.put(None)
            self._thread.join()

    def restore(self, template, shardings=None):
        return restore(self.dir, template, shardings=shardings)
