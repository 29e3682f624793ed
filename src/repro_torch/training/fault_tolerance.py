"""Fault tolerance: supervised training with restart, a straggler
watchdog and elastic re-mesh (the counterpart of
``repro.training.fault_tolerance``).

* ``run_supervised`` wraps a step function with catch -> restore the
  newest checkpoint -> resume, dropping the batch that failed.  In a
  data-parallel run every process restores; only one writes
  (``write_checkpoints``).  On a mesh with a ``"model"`` axis above 1
  (``shardings``, the state's placements) every process joins the
  gather of the whole leaves before the one writer writes them, and a
  restore cuts each process's piece.
* ``StepWatchdog`` keeps a rolling median of step times and flags a step
  slower than ``threshold`` x that median (once it has seen 5 steps).
* ``remesh`` places a host-side state on new devices: a checkpoint holds
  one replica, so scaling a data-parallel run up or down is a placement.

Each step's time ends with the device synchronised (the reference's
``block_until_ready``).
"""
from __future__ import annotations

import dataclasses
import logging
import time
import typing

import torch

from repro_torch.training import checkpoint as ckpt_lib
from repro_torch.training import tree as T

log = logging.getLogger(__name__)


@dataclasses.dataclass
class StepWatchdog:
    threshold: float = 2.5
    window: int = 50
    _times: list = dataclasses.field(default_factory=list)
    stragglers: list = dataclasses.field(default_factory=list)

    def observe(self, step: int, seconds: float) -> bool:
        """Record a step time; returns True if this step was a straggler."""
        self._times.append(seconds)
        if len(self._times) > self.window:
            self._times.pop(0)
        med = sorted(self._times)[len(self._times) // 2]
        is_straggler = len(self._times) >= 5 and seconds > self.threshold * med
        if is_straggler:
            self.stragglers.append((step, seconds, med))
        return is_straggler


def _wait_for(state) -> None:
    """Wait for the device that holds ``state``'s first tensor leaf."""
    first = next((x for x in T.leaves(state) if isinstance(x, torch.Tensor)), None)
    if first is not None and first.device.type == "cuda":
        torch.cuda.synchronize(first.device)


def run_supervised(
    step_fn,  # (state, batch) -> state
    state,  # tree (params, opt_state, ...)
    batches: typing.Iterable,
    *,
    ckpt_dir: str,
    ckpt_every: int = 100,
    max_restarts: int = 3,
    start_step: int = 0,
    watchdog: StepWatchdog | None = None,
    failure_injector=None,  # (step) -> None | raises (tests)
    on_restore=None,  # called with (state, step) after a restore
    write_checkpoints: bool = True,  # False on all but one replica
    shardings=None,  # the state's placements (sharding.tree_shardings)
):
    """Run steps with checkpoint / restart.  An exception from ``step_fn``
    restores the newest checkpoint and resumes with the next batch, up to
    ``max_restarts`` times.  Returns ``(state, steps, restarts)``."""
    manager = ckpt_lib.CheckpointManager(ckpt_dir, async_write=False)

    def checkpoint(at, state):
        whole = ckpt_lib.gather(state, shardings)  # every process of a model group
        if write_checkpoints:
            manager.save(at, whole)

    restarts = 0
    step = start_step
    it = iter(enumerate(batches, start=start_step))
    pending = None
    while True:
        try:
            if pending is None:
                try:
                    pending = next(it)
                except StopIteration:
                    break
            step, batch = pending
            if failure_injector is not None:
                failure_injector(step)
            t0 = time.perf_counter()
            state = step_fn(state, batch)
            _wait_for(state)
            if watchdog is not None:
                watchdog.observe(step, time.perf_counter() - t0)
            pending = None
            if (step + 1) % ckpt_every == 0:
                checkpoint(step + 1, state)
        except (StopIteration, KeyboardInterrupt):
            raise
        except Exception:
            log.warning("step %d failed (restart %d)", step, restarts + 1, exc_info=True)
            restarts += 1
            if restarts > max_restarts:
                raise
            last = ckpt_lib.latest_step(ckpt_dir)
            if last is not None:
                state, _ = ckpt_lib.restore(ckpt_dir, state, shardings=shardings)
                if on_restore is not None:
                    on_restore(state, last)
            # drop the failed batch and continue from the next one
            pending = None
    checkpoint(step + 1, state)
    return state, step + 1, restarts


def remesh(state_host, shardings):
    """Elastic re-mesh: place a host-side state tree (tensors or numpy, the
    port's layout) on ``shardings`` (a device, or a tree of devices)."""
    return T.place(state_host, shardings)
