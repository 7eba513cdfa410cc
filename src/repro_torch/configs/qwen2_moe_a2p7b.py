"""qwen2-moe-a2.7b — 24L d_model=2048 16H d_ff=1408 vocab=151936, 60e top-4.

[hf:Qwen/Qwen1.5-MoE-A2.7B; hf] 4 shared experts (shared intermediate 5632)
+ 60 routed experts top-4, every layer MoE (``attn:moe``), MHA with
head_dim 128, an untied head. Same values as
``repro/configs/qwen2_moe_a2p7b.py``.

Counts from the ParamSpecs: a layer holds 570,552,320 parameters
(519,045,120 in the 60 expert banks, 34,603,008 in the shared FFN,
16,777,216 in attention, 122,880 in the router, 4,096 in the norms); the
embedding, the final norm and the untied head 622,331,904 more. The port
serves all 24 layers on one card (``one_card_run()``) and trains a
three-layer cut (``one_card_train_config()``, ``one_card_train_run()``).
"""

import dataclasses

from repro_torch.configs._base import one_card, one_card_train
from repro_torch.models.common import MoECfg, ModelConfig, RunConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b", n_layers=24, d_model=2048, n_heads=16,
        n_kv_heads=16, d_ff=1408, vocab=151_936, d_head=128,
        moe=MoECfg(n_experts=60, top_k=4, d_ff_expert=1408,
                   n_shared=4, d_ff_shared=5632),
    )


def one_card_run() -> RunConfig:
    """Serving at full width and depth: 14,315,587,584 parameters,
    28,631,175,168 bytes of bf16 weights; at 8 slots of 2048 positions
    the bf16 KV cache takes 3,221,225,472 bytes more (24 layers x 2 x 16
    kv heads x 128)."""
    return one_card()


# the one-card training shape: one 4096-token sequence a micro-batch,
# four micro-batches (16,384 tokens a step)
TRAIN_SEQ, TRAIN_BATCH = 4096, 4


def one_card_train_config() -> ModelConfig:
    """The published widths trained on one card: one cut, depth 24 -> 3.

    Widths are not cut: d_model 2048, 16 heads of 128, all 60 experts of
    d_ff_expert 1408 at top-4 and capacity factor 1.25, the shared FFN
    of 5632, vocab 151936, an untied head. At full depth the 14.32 B
    parameters need 258-315 GB at the port's 18-22 bytes a parameter
    (bf16 params, float32 master weights, moments, gradients and
    ``acc_full``). Three layers are 1,711,656,960 parameters and the io
    622,331,904: 2,333,988,864 in all, 42.0-51.3 GB before activations
    (Jamba's cut, at the same 2.33 B, peaked at 64.6 GiB on the card
    with wider activations: d_ff 14336 against 1408 here).
    """
    return dataclasses.replace(config(), n_layers=3)


def one_card_train_run() -> RunConfig:
    """zeropp at pp 1 over the three layers as one stage block (vpp 1, as
    Jamba's cut), four micro-batches of one 4096-token sequence in units
    of two; bf16 params and compute, float32 master weights and
    moments."""
    return one_card_train(vpp=1)


def reduced():
    cfg = ModelConfig(
        name="qwen2-moe-smoke", n_layers=3, d_model=48, n_heads=4,
        n_kv_heads=4, d_ff=64, vocab=256, d_head=12,
        moe=MoECfg(capacity_factor=8.0, n_experts=8, top_k=2, d_ff_expert=64,
                   n_shared=1, d_ff_shared=96),
    )
    rc = RunConfig(pp=3, vpp=1, microbatches=2, param_dtype="float32",
                   compute_dtype="float32")
    return cfg, rc
