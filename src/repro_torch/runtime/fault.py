"""Fault-tolerant loops: training-step rollback and engine chip loss.

At thousand-node scale *something* fails every few minutes; a loop
must (a) checkpoint on a cadence, (b) catch step failures, (c) roll back
to the last checkpoint and continue, (d) give up only after repeated
failures at the same step.  Failures are injected in tests via
SimulatedFailure; on a card the same except-path catches the CUDA
errors torch raises as RuntimeError.

Two consumers share this module:

  * :class:`FaultTolerantLoop` -- the training-step rendering (step /
    batch / metrics history).
  * :class:`FaultInjector` / :class:`ChipLostError` -- the distributed
    graph engine's rendering: the injector is polled at every superstep
    host-accounting boundary of ``DistributedEngine.run`` and raises a
    chip loss once; the engine's recovery path re-places the lost chip's
    block on the surviving devices (``elastic.reshard_checkpoint``) and
    replays from the last superstep checkpoint, bit-identically.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Optional

import numpy as np
import torch

from ..checkpoint.ckpt import (flatten, latest_step, restore_checkpoint,
                               save_checkpoint, tree_map)

log = logging.getLogger("repro_torch.fault")


class SimulatedFailure(RuntimeError):
    """Raised by test hooks to emulate a node loss / link timeout."""


class ChipLostError(RuntimeError):
    """A chip (and the device hosting its block) dropped out mid-run.

    Raised by :class:`FaultInjector` inside ``DistributedEngine.run``'s
    boundary hook; the engine's retry loop catches it and recovers."""

    def __init__(self, chip: int, at_step: int):
        super().__init__(f"chip {chip} lost at superstep {at_step}")
        self.chip = int(chip)
        self.at_step = int(at_step)


@dataclasses.dataclass
class FaultInjector:
    """Injects one chip loss at a chosen (or seeded-random) superstep.

    ``poll(steps)`` is called by the distributed run loop at every
    superstep host-accounting boundary (per chunk on the chunked loop,
    per step on the per-step loop); the first boundary at or past
    ``at_superstep`` raises :class:`ChipLostError` once.  Because the
    chunked loop only observes steps at chunk granularity, the loss
    surfaces at the first boundary covering ``at_superstep`` -- exactly
    where a real loss would first be *detected* by the host.
    """

    at_superstep: int
    chip: int = 0
    fired: bool = False

    @classmethod
    def seeded(cls, seed: int, max_superstep: int,
               num_chips: int = 1) -> "FaultInjector":
        """Uniform random loss point in ``[1, max_superstep]`` and chip in
        ``[0, num_chips)`` from a deterministic seed (test harnesses)."""
        rng = np.random.default_rng(seed)
        return cls(
            at_superstep=int(rng.integers(1, max(int(max_superstep), 1) + 1)),
            chip=int(rng.integers(0, max(int(num_chips), 1))))

    def poll(self, steps: int) -> None:
        if not self.fired and steps >= self.at_superstep:
            self.fired = True
            raise ChipLostError(self.chip, steps)


def _to_host(x):
    """A metric on the host: ``.cpu()`` waits for the device, so a
    failure there surfaces inside the step's ``try``."""
    return x.cpu() if isinstance(x, torch.Tensor) else x


@dataclasses.dataclass
class FaultTolerantLoop:
    train_step: Callable            # (state, batch) -> (state, metrics)
    batch_at: Callable              # step -> batch (deterministic, seekable)
    ckpt_dir: str
    ckpt_every: int = 50
    max_retries_per_step: int = 3
    failure_hook: Optional[Callable] = None   # (step) -> None, may raise

    def _restore(self, state, step: int):
        """The checkpoint at ``step``, each tensor leaf on the device of
        the leaf it replaces."""
        devices = {k: v.device for k, v in flatten(state).items()
                   if isinstance(v, torch.Tensor)}
        return restore_checkpoint(self.ckpt_dir, state, step=step,
                                  placement=lambda key, _: devices.get(key))

    def run(self, state, num_steps: int, start_step: int = 0):
        """Runs to ``num_steps``; returns (state, history).  Restores from
        the newest checkpoint if one is ahead of start_step."""
        last = latest_step(self.ckpt_dir)
        if last is not None and last > start_step:
            state = self._restore(state, last)
            start_step = last
            log.info("restored checkpoint at step %d", last)
        history = []
        step = start_step
        retries = 0
        fail_step: Optional[int] = None
        while step < num_steps:
            batch = self.batch_at(step)
            try:
                if self.failure_hook is not None:
                    self.failure_hook(step)
                new_state, metrics = self.train_step(state, batch)
                # to the host inside the try, so device-side failures
                # surface here
                metrics = tree_map(_to_host, metrics)
            except (SimulatedFailure, RuntimeError) as e:
                # per-step retry budget: a failure at a *different* step
                # starts a fresh count (one flaky step must not eat
                # another's budget)
                if fail_step != step:
                    fail_step, retries = step, 0
                retries += 1
                log.warning("step %d failed (%s); retry %d", step, e,
                            retries)
                if retries > self.max_retries_per_step:
                    raise
                last = latest_step(self.ckpt_dir)
                if last is not None:
                    state = self._restore(state, last)
                    step = last
                    # roll metrics back with the state: the replayed
                    # steps re-append their metrics, so keeping the old
                    # entries would double-count every replayed step
                    del history[max(last - start_step, 0):]
                continue
            state = new_state
            history.append(metrics)
            step += 1
            if step % self.ckpt_every == 0:
                save_checkpoint(self.ckpt_dir, step, state)
        return state, history
