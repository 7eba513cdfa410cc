"""llama3.2-1b — 16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256.

[hf:meta-llama/Llama-3.2-1B; unverified] Small llama3: RoPE (theta 500k),
SwiGLU, RMSNorm, tied embeddings, head_dim 64. Same values as
``repro/configs/llama3p2_1b.py``.
"""

from repro_torch.configs._base import one_card, one_card_train
from repro_torch.models.common import ModelConfig, RunConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-1b", n_layers=16, d_model=2048, n_heads=32,
        n_kv_heads=8, d_ff=8192, vocab=128256, d_head=64,
        rope_theta=500_000.0, tie_embeddings=True,
    )


def one_card_run() -> RunConfig:
    return one_card()


def one_card_train_run() -> RunConfig:
    return one_card_train()


def reduced():
    cfg = ModelConfig(
        name="llama3.2-1b-smoke", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=256, d_head=16, tie_embeddings=True,
    )
    rc = RunConfig(pp=2, vpp=1, microbatches=2, param_dtype="float32",
                   compute_dtype="float32")
    return cfg, rc
