"""Data pipeline: deterministic synthetic LM stream + memmap token reader.

Port of :mod:`repro.data.pipeline`. The streams are numpy, so a batch is
byte-identical to the reference's. Determinism contract for fault
tolerance: batch(step) is a pure function of (seed, step), so a restarted
job replays the exact stream. :func:`shard_batch` places a host batch on
the device; under a mesh each rank uploads its rows only (data rank d
of D takes rows [d B/D, (d+1) B/D) of the same global batch).
"""
from __future__ import annotations

import os
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import RunConfig


class SyntheticLM:
    """Markov-ish synthetic token stream with learnable structure (bigram
    transitions), so losses genuinely decrease during the examples."""

    def __init__(self, rcfg: RunConfig, seed: int = 0,
                 batch_override: Optional[int] = None,
                 seq_override: Optional[int] = None):
        self.rcfg = rcfg
        self.seed = seed
        self.vocab = rcfg.model.vocab_size
        self.batch = batch_override or rcfg.shape.global_batch
        self.seq = seq_override or rcfg.shape.seq_len
        rng = np.random.default_rng(seed)
        # sparse bigram structure: each token prefers a few successors
        self.succ = rng.integers(0, self.vocab, size=(self.vocab, 4))

    def batch_at(self, step: int) -> Dict[str, Any]:
        rng = np.random.default_rng((self.seed * 1_000_003 + step) & 0x7FFFFFFF)
        toks = np.empty((self.batch, self.seq + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, size=self.batch)
        noise = rng.random((self.batch, self.seq))
        choice = rng.integers(0, 4, size=(self.batch, self.seq))
        rand_tok = rng.integers(0, self.vocab, size=(self.batch, self.seq))
        for t in range(self.seq):
            nxt = self.succ[toks[:, t], choice[:, t]]
            toks[:, t + 1] = np.where(noise[:, t] < 0.15, rand_tok[:, t], nxt)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        cfg = self.rcfg.model
        if cfg.family == "encdec":
            if cfg.frontend == "audio":   # stubbed frame embeddings
                batch["src_embeds"] = rng.standard_normal(
                    (self.batch, self.seq, cfg.d_model)).astype(
                        np.float32) * 0.1
            else:                          # text source (MT)
                batch["src_tokens"] = rng.integers(
                    0, self.vocab, size=(self.batch, self.seq)).astype(
                        np.int32)
        if cfg.frontend == "vision":
            batch["mm_embeds"] = rng.standard_normal(
                (self.batch, 4, cfg.d_model)).astype(np.float32) * 0.1
        return batch

    def iterate(self, start_step: int = 0) -> Iterator[Dict[str, Any]]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


class MemmapLM:
    """nanoGPT-style flat token file reader (``train.bin`` of uint16)."""

    def __init__(self, path: str, rcfg: RunConfig, seed: int = 0):
        self.data = np.memmap(path, dtype=np.uint16, mode="r")
        self.rcfg = rcfg
        self.seed = seed
        self.batch = rcfg.shape.global_batch
        self.seq = rcfg.shape.seq_len

    def batch_at(self, step: int) -> Dict[str, Any]:
        rng = np.random.default_rng((self.seed * 1_000_003 + step) & 0x7FFFFFFF)
        ix = rng.integers(0, len(self.data) - self.seq - 1, size=self.batch)
        toks = np.stack([self.data[i:i + self.seq + 1].astype(np.int32)
                         for i in ix])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_pipeline(rcfg: RunConfig, seed: int = 0, data_path: str = "",
                  **kw):
    if data_path and os.path.exists(data_path):
        return MemmapLM(data_path, rcfg, seed)
    return SyntheticLM(rcfg, seed, **kw)


def shard_batch(batch, device, mesh=None,
                rcfg: Optional[RunConfig] = None) -> Dict[str, torch.Tensor]:
    """Upload a host numpy batch: integer arrays (tokens, labels) as int64,
    float arrays (stub embeddings) as float32. Under ``mesh`` (with
    ``rcfg`` for its sharding rules) only this rank's rows."""
    if mesh is not None:
        from repro_torch.parallel import params as pparams
        specs = pparams.batch_specs(batch, rcfg, mesh)
        batch = {k: pparams.local_slice(a, (k,), specs[k], mesh)
                 for k, a in batch.items()}
    return {k: torch.from_numpy(np.ascontiguousarray(a)).to(
        device, torch.long if a.dtype.kind in "iu" else torch.float32)
        for k, a in batch.items()}
