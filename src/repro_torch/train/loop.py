"""The training loop: checkpoint/restart, straggler watch, failure injection.

Fault-tolerance contract (as the reference's):

* every ``ckpt_every`` steps the full state is saved atomically; a restart
  resumes from the latest manifest (``maybe_restore``),
* a ``FailureInjector`` can kill the run at a chosen step to prove
  restart-exactness (the loss curve continues on resume when the data
  cursor is restored too),
* the step-time watchdog flags stragglers (EMA z-score) through a
  callback; on a fleet it would re-queue the worker's qd-tree blocks
  through the elastic block scheduler (``data/pipeline.py``).

A step is timed until its loss reaches the host, the counterpart of the
reference's ``block_until_ready``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator, Optional

from repro_torch.train import checkpoint as ckpt_lib


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    ckpt_keep: int = 3
    ckpt_async: bool = False
    log_every: int = 10
    straggler_z: float = 4.0  # flag steps slower than mean + z·std
    straggler_warmup: int = 10


class FailureInjector:
    """Deterministic failure for restart tests."""

    def __init__(self, fail_at_step: Optional[int] = None):
        self.fail_at_step = fail_at_step

    def maybe_fail(self, step: int) -> None:
        if self.fail_at_step is not None and step == self.fail_at_step:
            raise RuntimeError(f"injected failure at step {step}")


@dataclasses.dataclass
class StragglerWatch:
    """EMA step-time watchdog; fires ``on_straggle`` for slow steps."""

    z: float
    warmup: int
    on_straggle: Optional[Callable[[int, float, float], None]] = None
    _n: int = 0
    _mean: float = 0.0
    _m2: float = 0.0
    flagged: int = 0

    def observe(self, step: int, dt: float) -> None:
        self._n += 1
        delta = dt - self._mean
        self._mean += delta / self._n
        self._m2 += delta * (dt - self._mean)
        if self._n <= self.warmup:
            return
        std = (self._m2 / max(self._n - 1, 1)) ** 0.5
        if std > 0 and dt > self._mean + self.z * std:
            self.flagged += 1
            if self.on_straggle:
                self.on_straggle(step, dt, self._mean)


def train_loop(step_fn, state, batches: Iterator, cfg: LoopConfig,
               failure: Optional[FailureInjector] = None, on_straggle=None,
               log=print):
    """Run ``step_fn(state, batch) -> (state, metrics)`` to total_steps,
    from the state's own step (a restored state resumes; see
    ``maybe_restore``).  Returns (state, history list of metric dicts)."""
    history = []
    watch = StragglerWatch(cfg.straggler_z, cfg.straggler_warmup,
                           on_straggle)
    start = int(state["step"])
    for step in range(start, cfg.total_steps):
        if failure is not None:
            failure.maybe_fail(step)
        batch = next(batches)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        float(metrics["loss"])  # waits for the step's device work
        dt = time.perf_counter() - t0
        watch.observe(step, dt)
        m = {k: float(v) for k, v in metrics.items()}
        m["step"] = step
        m["wall_s"] = dt
        history.append(m)
        if cfg.log_every and step % cfg.log_every == 0:
            log(f"step {step}: loss={m['loss']:.4f} "
                f"lr={m.get('lr', 0):.2e} {dt*1e3:.0f}ms")
        if (cfg.ckpt_dir and cfg.ckpt_every
                and (step + 1) % cfg.ckpt_every == 0):
            ckpt_lib.save_checkpoint(
                cfg.ckpt_dir, step + 1, state, keep=cfg.ckpt_keep,
                async_save=cfg.ckpt_async,
            )
    if cfg.ckpt_dir:
        ckpt_lib.save_checkpoint(cfg.ckpt_dir, cfg.total_steps, state,
                                 keep=cfg.ckpt_keep)
    return state, history


def maybe_restore(ckpt_dir, abstract_state, device=None, placements=None):
    """→ (state or None, step).  None ⇒ cold start.  ``placements`` lays
    the restored state out on a mesh (``restore_checkpoint``)."""
    if ckpt_dir is None:
        return None, 0
    step = ckpt_lib.latest_step(ckpt_dir)
    if step is None:
        return None, 0
    state = ckpt_lib.restore_checkpoint(ckpt_dir, step, abstract_state,
                                        device, placements)
    return state, step
