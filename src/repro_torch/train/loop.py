"""The training loop: step function + data + checkpoints + fault tolerance,
the JAX package's `repro.train.loop`.

Every restart path (preemption, crash) resumes bit-exact from (checkpoint,
data pipeline state, rng): `resume_or_init` restores the latest checkpoint
into a freshly built state.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import DataLoader
from repro_torch.train.ft import PreemptionHandler, StepTimer, StragglerDetector


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_every: int = 100
    log_every: int = 10
    keep_ckpts: int = 3


def run_train_loop(
    *,
    train_step: Callable,
    state: dict,
    loader: DataLoader,
    ckpt: CheckpointManager,
    loop_cfg: LoopConfig,
    start_step: int = 0,
    host_id: int = 0,
    n_hosts: int = 1,
    log_fn: Callable[[str], None] = print,
    install_signal_handlers: bool = True,
) -> tuple[dict, dict]:
    """Returns (final_state, summary). The summary holds the JAX
    package's keys (final_step, final_loss, mean_step_time_s, loss_curve,
    stragglers, preempted) and, per step, ``step_times_s`` and
    ``grad_norms``."""
    timer = StepTimer()
    stragglers = StragglerDetector(n_hosts)
    preempt = PreemptionHandler(install=install_signal_handlers)
    losses, times, norms = [], [], []
    step = start_step
    flagged_hosts: list[int] = []

    while step < loop_cfg.total_steps:
        batch = loader.next()
        timer.start()
        state, metrics = train_step(state, batch)
        # block on the loss so step time includes device work
        loss = float(metrics["loss"])
        dt = timer.stop()
        gnorm = float(metrics["grad_norm"])
        losses.append(loss)
        times.append(dt)
        norms.append(gnorm)
        stragglers.record(host_id, dt)
        flagged_hosts = stragglers.update_flags()
        step += 1

        if step % loop_cfg.log_every == 0:
            tokens = int(np.asarray(batch["tokens"]).size)
            log_fn(f"step {step:6d} loss {loss:.4f} grad_norm {gnorm:.4f} "
                   f"({dt * 1e3:.0f} ms/step, {tokens / dt:.0f} tokens/s)"
                   + (f" STRAGGLERS={flagged_hosts}" if flagged_hosts else ""))
        if step % loop_cfg.ckpt_every == 0:
            ckpt.save(step, state, data_state=loader.checkpoint())
        if preempt.preempted:
            log_fn(f"preempted at step {step}; saving final checkpoint")
            ckpt.save(step, state, data_state=loader.checkpoint(),
                      blocking=True)
            break

    ckpt.wait()
    summary = {
        "final_step": step,
        "final_loss": losses[-1] if losses else float("nan"),
        "mean_step_time_s": timer.mean,
        "loss_curve": np.array(losses),
        "step_times_s": np.array(times),
        "grad_norms": np.array(norms),
        "stragglers": flagged_hosts,
        "preempted": preempt.preempted,
    }
    preempt.restore()
    return state, summary


def resume_or_init(
    *,
    ckpt: CheckpointManager,
    init_fn: Callable[[], dict],
    loader: DataLoader,
) -> tuple[dict, int]:
    """Restart-safe state construction: a fresh state from `init_fn`, with
    the latest checkpoint, if there is one, restored into it (on the
    state's devices) and the loader moved to its position. Returns (state,
    the step to start from)."""
    state = init_fn()
    latest = ckpt.latest_step()
    if latest is None:
        return state, 0
    state, data_state = ckpt.restore(latest, into=state)
    if data_state is not None:
        loader.restore(data_state)
    return state, latest
