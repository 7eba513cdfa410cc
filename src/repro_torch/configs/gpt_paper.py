"""The paper's GPT models (Table 4): 1.5B / 6.2B / 14.6B, seq 1024.

MHA with head_dim = d_model / n_heads (96 for 1.5B, 128 for the others),
LayerNorm, the GELU MLP (d_ff = 4 d_model), RoPE at theta 10 000, an
untied head, vocab 50304. Same values as ``repro/configs/gpt_paper.py``.

The port trains and serves the 1.5B model at its published width and
depth on one card: 1,633,430,016 parameters. Training
(``one_card_train_run()``) holds about 29.4 GB of bf16 params, float32
master, moments and grads. Serving (``one_card_run()``) holds
3,266,860,032 bytes of bf16 weights and, at 8 slots of its 1024
positions, a bf16 KV cache of 1,660,944,384 bytes (22 layers x K and V
x 24 heads x 96); its attention runs K3 (contiguous cache) or K4 (page
pool) at head_dim 96.
"""

from repro_torch.configs._base import one_card, one_card_train
from repro_torch.models.common import ModelConfig, RunConfig

SIZES = {
    "1.5B": dict(n_layers=22, n_heads=24, d_model=2304),
    "6.2B": dict(n_layers=30, n_heads=32, d_model=4096),
    "14.6B": dict(n_layers=46, n_heads=40, d_model=5120),
}

# the one-card training shape: two 1024-token sequences a micro-batch,
# four micro-batches (8192 tokens a step, as llama3.2-1b's 4 x 2048)
TRAIN_SEQ, TRAIN_BATCH = 1024, 8


def config(size: str = "1.5B") -> ModelConfig:
    s = SIZES[size]
    return ModelConfig(
        name=f"gpt-{size}", n_layers=s["n_layers"], d_model=s["d_model"],
        n_heads=s["n_heads"], n_kv_heads=s["n_heads"],
        d_ff=4 * s["d_model"], vocab=50304,
        norm="layernorm", act="gelu_mlp", max_seq=1024,
    )


def one_card_run() -> RunConfig:
    return one_card()


def one_card_train_run() -> RunConfig:
    return one_card_train()


def reduced():
    cfg = ModelConfig(
        name="gpt-smoke", n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=256, vocab=256, d_head=16, norm="layernorm", act="gelu_mlp",
    )
    rc = RunConfig(pp=2, vpp=2, microbatches=2, param_dtype="float32",
                   compute_dtype="float32")
    return cfg, rc
