"""Data pipeline: deterministic synthetic corpus + sharded batching +
background prefetch.

A copy of ``repro.data.pipeline`` (numpy and threading only), owned by the
port so that it imports nothing of the reference; the same config and
cursor give the same batches in both packages.

The corpus is a seeded token stream (a fixed "document" distribution with
Zipfian token frequencies and document boundaries), so training runs are
reproducible and loss curves comparable across configurations.  The loader
is *stateful and checkpointable*: its cursor is part of the training state,
so checkpoint/restart resumes mid-epoch without skipping or repeating data.

``ShardedLoader`` yields global batches laid out for the mesh's batch axis;
a background thread keeps ``prefetch`` batches ready so host-side batch
assembly overlaps device compute.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass
class DataConfig:
    vocab_size: int = 32000
    seq_len: int = 1024
    global_batch: int = 8
    seed: int = 1234
    doc_len_mean: int = 512
    zipf_a: float = 1.2
    frontend_tokens: int = 0      # VLM stub: patch positions per sequence
    d_model: int = 0              # patch embedding dim (vlm stub)


class SyntheticCorpus:
    """Deterministic, seekable token stream."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def tokens_at(self, cursor: int, n: int) -> np.ndarray:
        """n tokens starting at absolute position ``cursor`` — O(n), seeded
        per 1k-block so any offset is reproducible without replay."""
        cfg = self.cfg
        out = np.empty(n, dtype=np.int32)
        got = 0
        block = cursor // 1024
        off = cursor % 1024
        while got < n:
            rng = np.random.default_rng((cfg.seed, block))
            toks = rng.zipf(cfg.zipf_a, size=1024).astype(np.int64)
            toks = (toks - 1) % max(2, cfg.vocab_size - 2) + 2
            # document boundaries -> BOS(1)
            bos = rng.random(1024) < (1.0 / max(2, cfg.doc_len_mean))
            toks[bos] = 1
            take = min(1024 - off, n - got)
            out[got:got + take] = toks[off:off + take]
            got += take
            block += 1
            off = 0
        return out


class ShardedLoader:
    def __init__(self, cfg: DataConfig, start_cursor: int = 0,
                 prefetch: int = 2):
        self.cfg = cfg
        self.corpus = SyntheticCorpus(cfg)
        self.cursor = start_cursor
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _make_batch(self, cursor: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        span = cfg.seq_len + 1
        n = cfg.global_batch * span
        flat = self.corpus.tokens_at(cursor, n).reshape(
            cfg.global_batch, span)
        batch = {
            "tokens": flat[:, :-1].astype(np.int32),
            "targets": flat[:, 1:].astype(np.int32),
            "loss_mask": np.ones((cfg.global_batch, cfg.seq_len),
                                 dtype=np.float32),
        }
        if cfg.frontend_tokens:
            rng = np.random.default_rng((cfg.seed, cursor, 7))
            batch["patches"] = rng.standard_normal(
                (cfg.global_batch, cfg.frontend_tokens, cfg.d_model)
            ).astype(np.float32) * 0.02
        return batch

    def _fill(self):
        cursor = self.cursor
        span = self.cfg.global_batch * (self.cfg.seq_len + 1)
        while not self._stop.is_set():
            b = self._make_batch(cursor)
            b["_cursor"] = cursor + span
            while not self._stop.is_set():
                try:
                    self._q.put(b, timeout=0.1)
                    break
                except queue.Full:
                    continue
            cursor += span

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        b = self._q.get()
        self.cursor = b.pop("_cursor")
        return b

    def state(self) -> dict:
        return {"cursor": self.cursor}

    def close(self):
        self._stop.set()
