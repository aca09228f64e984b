"""Deterministic synthetic data pipeline (a copy of ``repro.data.pipeline``:
the same numpy draws, so the same bits).

Tokens are drawn from a learnable synthetic language: each sequence repeats
a document "motif" (one of a small pool of random n-grams) with occasional
uniform noise, so cross-entropy drops measurably within a few hundred steps
-- enough signal for the end-to-end training example and the fault-tolerance
(restart-bitexactness) tests.  Batches are a pure function of
(seed, step, shard), so any worker can regenerate any shard of any step:
this is the elastic/fault-tolerant contract (no data-state checkpointing
needed beyond the step counter).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

from ..configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_motifs: int = 64
    motif_len: int = 16
    noise: float = 0.05


def _motifs(cfg: DataConfig) -> np.ndarray:
    rng = np.random.default_rng(cfg.seed)
    return rng.integers(1, cfg.vocab, size=(cfg.n_motifs, cfg.motif_len),
                        dtype=np.int32)


def batch_at(cfg: DataConfig, step: int, shard: int = 0,
             num_shards: int = 1) -> dict:
    """The (step, shard) batch as numpy int32 arrays {tokens, labels}."""
    assert cfg.global_batch % num_shards == 0
    bsz = cfg.global_batch // num_shards
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, shard]))
    motifs = _motifs(cfg)
    ids = rng.integers(0, cfg.n_motifs, size=bsz)
    reps = -(-(cfg.seq_len + 1) // cfg.motif_len)
    seq = np.tile(motifs[ids], (1, reps))[:, : cfg.seq_len + 1]
    noise_mask = rng.random(seq.shape) < cfg.noise
    seq = np.where(noise_mask,
                   rng.integers(1, cfg.vocab, size=seq.shape), seq)
    return {"tokens": seq[:, :-1].astype(np.int32),
            "labels": seq[:, 1:].astype(np.int32)}


def stream(cfg: DataConfig, start_step: int = 0, shard: int = 0,
           num_shards: int = 1) -> Iterator[dict]:
    step = start_step
    while True:
        yield batch_at(cfg, step, shard, num_shards)
        step += 1


def for_model(model: ModelConfig, shape: ShapeConfig, seed: int = 0
              ) -> DataConfig:
    return DataConfig(vocab=model.vocab, seq_len=shape.seq_len,
                      global_batch=shape.global_batch, seed=seed)


def frontend_stub(model: ModelConfig, shape: ShapeConfig, step: int,
                  seed: int = 0) -> Optional[np.ndarray]:
    """Precomputed modality embeddings for [audio]/[vlm] backbones."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step, 777]))
    if model.family == "encdec":
        shp = (shape.global_batch, shape.seq_len, model.d_model)
    elif model.family == "vlm":
        shp = (shape.global_batch, model.n_img_tokens, model.d_model)
    else:
        return None
    return (rng.standard_normal(shp) * 0.02).astype(np.float32)
