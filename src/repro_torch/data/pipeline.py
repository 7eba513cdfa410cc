"""Deterministic synthetic token pipeline (numpy only).

The port's copy of ``DataConfig`` and ``SyntheticStream`` from
``repro/data/pipeline.py`` for token models, the audio stub and the
vision stub: sample ``i`` is a function of the seed and ``i`` alone, so
the port and the reference draw the same batches. An ``enc_dec``
sample adds ``enc_tokens``, the audio stub's float frame embeddings
[enc_ctx, d_model], and a ``vision`` sample's ``tokens`` are float patch
embeddings [s, d_model]; both are drawn after the same token draws as
the reference's.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class DataConfig:
    seq_len: int
    global_batch: int
    vocab: int
    seed: int = 0
    kind: str = "lm"          # lm | enc_dec | vision
    d_model: int = 0          # for stub embeddings
    enc_ctx: int = 0
    structure: int = 97       # synthetic data has learnable structure:
    # token t+1 = (a * token_t + b) % structure-ish mixture + noise


class SyntheticStream:
    """Deterministic, seekable global sample stream.

    Sample ``i`` is generated independently of batch size or sharding, so
    checkpoint/restart and elastic re-sharding resume exactly.
    """

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def sample(self, i: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed * 1_000_003 + i)
        s = cfg.seq_len
        # affine-recurrence tokens with noise: learnable but nontrivial
        a = int(rng.integers(2, 8))
        b = int(rng.integers(0, cfg.structure))
        x0 = int(rng.integers(0, cfg.structure))
        toks = np.empty(s + 1, np.int32)
        toks[0] = x0
        for t in range(s):
            toks[t + 1] = (a * toks[t] + b) % cfg.structure
        noise = rng.random(s + 1) < 0.05
        toks = np.where(noise, rng.integers(0, cfg.vocab, s + 1), toks)
        toks = (toks % cfg.vocab).astype(np.int32)
        out = {"tokens": toks[:-1], "labels": toks[1:]}
        if cfg.kind == "enc_dec":
            out["enc_tokens"] = rng.standard_normal(
                (cfg.enc_ctx, cfg.d_model)).astype(np.float32) * 0.1
        if cfg.kind == "vision":
            out["tokens"] = rng.standard_normal(
                (s, cfg.d_model)).astype(np.float32) * 0.1
        return out

    def batch(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        base = step * cfg.global_batch
        samples = [self.sample(base + j) for j in range(cfg.global_batch)]
        return {
            k: np.stack([s[k] for s in samples]) for k in samples[0]
        }
