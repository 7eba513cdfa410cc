"""yi-9b — 48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.

[arXiv:2403.04652; hf] llama-architecture GQA dense decoder: RMSNorm,
SwiGLU, RoPE (theta 5e6), an untied head, head_dim 128. Same values as
``repro/configs/yi_9b.py``.
"""

from repro_torch.configs._base import one_card, one_card_train
from repro_torch.models.common import ModelConfig, RunConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-9b", n_layers=48, d_model=4096, n_heads=32,
        n_kv_heads=4, d_ff=11008, vocab=64000, d_head=128,
        rope_theta=5_000_000.0,
    )


def one_card_run() -> RunConfig:
    """Serving at full width and depth: 8,829,407,232 parameters (from the
    ParamSpecs), 17,658,814,464 bytes of bf16 weights; at 8 slots of 2048
    positions the bf16 KV cache takes 1,610,612,736 bytes more (48 layers
    x 2 x 4 kv heads x 128)."""
    return one_card()


def one_card_train_run() -> RunConfig:
    """Training on one card, with the depth cut by the session's ``layers=``:
    at full depth the 8,829,407,232 parameters need 158,929,330,176 to
    194,246,959,104 bytes (18-22 bytes a parameter: bf16 params, float32
    master, moments and grads, the float32 accumulator) before any
    activation, more than the card's 80 GB."""
    return one_card_train()


def reduced():
    cfg = ModelConfig(
        name="yi-9b-smoke", n_layers=6, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=160, vocab=256, d_head=16,
    )
    rc = RunConfig(pp=2, vpp=3, microbatches=2, param_dtype="float32",
                   compute_dtype="float32")
    return cfg, rc
