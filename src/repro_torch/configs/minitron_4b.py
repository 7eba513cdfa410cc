"""minitron-4b — 32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000.

[arXiv:2407.14679; hf] Width/depth-pruned Nemotron; GQA, SwiGLU, RMSNorm,
RoPE, an untied head over a huge vocabulary, head_dim 128. Same values
as ``repro/configs/minitron_4b.py``.
"""

from repro_torch.configs._base import one_card, one_card_train
from repro_torch.models.common import ModelConfig, RunConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minitron-4b", n_layers=32, d_model=3072, n_heads=24,
        n_kv_heads=8, d_ff=9216, vocab=256_000, d_head=128,
    )


def one_card_run() -> RunConfig:
    """Serving at full width and depth: 5,096,279,040 parameters (from the
    ParamSpecs), 10,192,558,080 bytes of bf16 weights."""
    return one_card()


def one_card_train_run() -> RunConfig:
    """Training on one card, with the depth cut by the session's ``layers=``:
    at full depth the 5,096,279,040 parameters need 91,733,022,720 to
    112,118,138,880 bytes (18-22 bytes a parameter: bf16 params, float32
    master, moments and grads, the float32 accumulator) before any
    activation, more than the card's 80 GB."""
    return one_card_train()


def reduced():
    cfg = ModelConfig(
        name="minitron-4b-smoke", n_layers=4, d_model=48, n_heads=4,
        n_kv_heads=2, d_ff=96, vocab=512, d_head=12,
    )
    rc = RunConfig(pp=2, vpp=2, microbatches=2, param_dtype="float32",
                   compute_dtype="float32")
    return cfg, rc
