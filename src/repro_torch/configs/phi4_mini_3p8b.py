"""phi4-mini-3.8b — 32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064.

[arXiv:2412.08905; hf] RoPE + SwiGLU + GQA dense decoder with RMSNorm,
an untied head and head_dim 128. Same values as
``repro/configs/phi4_mini_3p8b.py``.
"""

from repro_torch.configs._base import one_card, one_card_train
from repro_torch.models.common import ModelConfig, RunConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi4-mini-3.8b", n_layers=32, d_model=3072, n_heads=24,
        n_kv_heads=8, d_ff=8192, vocab=200_064, d_head=128,
    )


def one_card_run() -> RunConfig:
    """Serving at full width and depth: 4,450,618,368 parameters (from the
    ParamSpecs), 8,901,236,736 bytes of bf16 weights."""
    return one_card()


def one_card_train_run() -> RunConfig:
    """Training on one card, with the depth cut by the session's ``layers=``:
    at full depth the 4,450,618,368 parameters need 80,111,130,624 to
    97,913,604,096 bytes (18-22 bytes a parameter: bf16 params, float32
    master, moments and grads, the float32 accumulator) before any
    activation, more than the card's 80 GB."""
    return one_card_train()


def reduced():
    cfg = ModelConfig(
        name="phi4-mini-smoke", n_layers=4, d_model=48, n_heads=4,
        n_kv_heads=2, d_ff=96, vocab=512, d_head=12,
    )
    rc = RunConfig(pp=2, vpp=2, microbatches=2, param_dtype="float32",
                   compute_dtype="float32")
    return cfg, rc
