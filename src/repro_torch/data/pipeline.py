"""Deterministic, resumable, shardable synthetic data pipeline: a copy of
the JAX package's `repro.data.pipeline` (numpy only), whose batches are the
reference's bit for bit, and `smoke_batch`, the materialized batch of a
reduced config, built on the configs' input specs with the reference's
draws.

Production shape: an index-based sampler (step -> global batch) so any host
can materialize exactly its shard of any step without coordination — the
property that makes checkpoint-resume and elastic re-sharding trivial
(the sampler is a pure function of (seed, step)).

Synthetic text: a mixture of Zipfian unigrams and a repeated-ngram process so
the LM loss actually decreases during the example runs (pure uniform noise
would pin loss at log V).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class DataConfig:
    seq_len: int
    global_batch: int
    vocab: int
    seed: int = 0
    zipf_alpha: float = 1.2
    repeat_prob: float = 0.5   # prob. a token copies seq_len//8 back


class SyntheticLMDataset:
    """Pure-function batch source: batch_at(step) is deterministic."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_alpha)
        self.probs = probs / probs.sum()

    def batch_at(self, step: int, *, host_id: int = 0,
                 n_hosts: int = 1) -> dict[str, np.ndarray]:
        cfg = self.cfg
        if cfg.global_batch % n_hosts:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split over {n_hosts} hosts")
        local = cfg.global_batch // n_hosts
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, host_id]))
        toks = rng.choice(cfg.vocab, size=(local, cfg.seq_len + 1),
                          p=self.probs).astype(np.int32)
        # inject copy structure: some positions repeat lag-k history
        lag = max(cfg.seq_len // 8, 1)
        copy_mask = rng.random((local, cfg.seq_len + 1)) < cfg.repeat_prob
        copy_mask[:, :lag] = False
        idx = np.arange(cfg.seq_len + 1)[None, :] - lag
        toks = np.where(copy_mask, np.take_along_axis(
            toks, np.broadcast_to(idx, toks.shape).clip(0), axis=1), toks)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


@dataclasses.dataclass
class PipelineState:
    """Checkpointable pipeline position."""
    step: int = 0

    def to_dict(self) -> dict:
        return {"step": self.step}

    @staticmethod
    def from_dict(d: dict) -> "PipelineState":
        return PipelineState(step=int(d["step"]))


class DataLoader:
    """Host-sharded loader with a software prefetch queue and resume."""

    def __init__(self, dataset: SyntheticLMDataset, *, host_id: int = 0,
                 n_hosts: int = 1, prefetch: int = 2,
                 state: PipelineState | None = None):
        self.dataset = dataset
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.prefetch = prefetch
        self.state = state or PipelineState()
        self._queue: list[dict] = []

    def _fill(self):
        while len(self._queue) < self.prefetch:
            step = self.state.step + len(self._queue)
            self._queue.append(
                self.dataset.batch_at(step, host_id=self.host_id,
                                      n_hosts=self.n_hosts))

    def next(self) -> dict[str, np.ndarray]:
        self._fill()
        batch = self._queue.pop(0)
        self.state.step += 1
        return batch

    def checkpoint(self) -> dict:
        return self.state.to_dict()

    def restore(self, d: dict) -> None:
        self.state = PipelineState.from_dict(d)
        self._queue.clear()


_NP_INT = {torch.int32: np.int32, torch.int64: np.int64}


def smoke_batch(arch: str, shape: str = "train_4k", seed: int = 0
                ) -> tuple:
    """(reduced config, materialized batch of numpy arrays) for any
    assigned arch: the reference's `smoke_batch`, the same generator and
    the same draws in the same order, so its arrays are the reference's.
    Token ids uniform over the vocab, M-RoPE positions of the patch grid,
    a loss mask of 0 on the patches, float inputs N(0, 1) in f32 (the
    model casts them to its activation dtype)."""
    from repro_torch.configs import get_config, input_specs

    cfg = get_config(arch, smoke=True)
    specs = input_specs(arch, shape, smoke=True)
    rng = np.random.default_rng(seed)
    batch = {}
    for name, spec in specs.items():
        if name == "state":
            continue
        shape_ = spec.shape
        if name in ("tokens", "labels", "token"):
            batch[name] = rng.integers(0, cfg.vocab, shape_).astype(
                _NP_INT[spec.dtype])
        elif name == "positions_3d":
            from repro_torch.models.vlm import build_mrope_positions

            B, S, _ = shape_
            n_patch = S - specs["tokens"].shape[1]
            grid = (4, 4) if n_patch == 16 else (32, 32)
            pos = build_mrope_positions(n_patch, grid, S - n_patch)
            batch[name] = np.broadcast_to(pos, (B, S, 3)).astype(
                _NP_INT[spec.dtype])
        elif name == "loss_mask":
            B, S = shape_
            n_patch = S - specs["tokens"].shape[1]
            m = np.ones((B, S), np.float32)
            m[:, :n_patch] = 0.0
            batch[name] = m
        else:  # float embeddings (the model casts to its activation dtype)
            batch[name] = rng.normal(size=shape_).astype(np.float32)
    return cfg, batch
