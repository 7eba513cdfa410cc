"""xlstm-1.3b — 48L d_model=2048 4H d_ff=0 vocab=50304, sLSTM + mLSTM.

[arXiv:2405.04517; unverified] Post-up-projection mLSTM blocks (factor 2)
with sLSTM blocks interleaved; d_ff=0, so no separate FFN: every layer is
``mlstm:none`` or ``slstm:none``, the mixer alone. Same values as
``repro/configs/xlstm_1p3b.py``, including its deviation: an sLSTM every
sixth layer (``slstm_every=6``, 5 mLSTM : 1 sLSTM) in place of the
paper's xLSTM[7:1].

Counts from the ParamSpecs: an mLSTM layer holds 75,532,296 parameters
(di = 4096, 4 heads of e = 1024, each with a float32 matrix state C
[1024, 1024] when served), an sLSTM layer 20,981,760 (4 heads of 512);
the embedding, the final norm and the untied head 206,047,232 more. The
port serves all 48 layers on one card (``one_card_run()``) and trains a
24-layer cut (``one_card_train_config()``, ``one_card_train_run()``).
"""

import dataclasses

from repro_torch.configs._base import one_card, one_card_train
from repro_torch.models.common import ModelConfig, RunConfig, XLSTMCfg


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b", n_layers=48, d_model=2048, n_heads=4,
        n_kv_heads=4, d_ff=0, vocab=50304, d_head=512,
        xlstm=XLSTMCfg(slstm_every=6, proj_factor=2.0),
    )


def one_card_run() -> RunConfig:
    """Serving at full width and depth: 3,395,193,152 parameters,
    6,790,386,304 bytes of bf16 weights; at 8 slots the recurrent state
    takes 5,375,529,984 bytes more (40 mLSTM layers x 8 x 4 heads x
    (1024 x 1024 + 1024 + 1) float32, and 8 sLSTM layers x 3 x 8 x 2048
    float32), whatever the context."""
    return one_card()


# the one-card training shape: the xLSTM paper's training context of
# 2048 tokens, two sequences a micro-batch, four micro-batches (16,384
# tokens a step)
TRAIN_SEQ, TRAIN_BATCH = 2048, 8


def one_card_train_config() -> ModelConfig:
    """The published widths trained on one card: one cut, depth 48 -> 24.

    Widths are not cut: d_model 2048, 4 heads, proj_factor 2 (mLSTM heads
    of 1024, sLSTM heads of 512), vocab 50304, an untied head, an sLSTM
    every sixth layer. At full depth the 3,395,193,152 parameters need
    61.1-74.7 GB at the port's 18-22 bytes a parameter (bf16 params,
    float32 master weights, moments, gradients and ``acc_full``) before
    activations: with them (qwen2-moe's and phi-3-vision's cuts peaked at
    28-32 bytes a parameter) more than the card's 80 GB. 24 layers (20
    mLSTM, 4 sLSTM) are 1,594,572,960 parameters and the io 206,047,232:
    1,800,620,192 in all, 32.4-39.6 GB before activations.
    """
    return dataclasses.replace(config(), n_layers=24)


def one_card_train_run() -> RunConfig:
    """zeropp at pp 1 with the stage blocks interleaved (vpp 2, k = 12
    layers a block, two sLSTM periods of 6), four micro-batches of two
    2048-token sequences in units of two; bf16 params and compute,
    float32 master weights and moments."""
    return one_card_train(vpp=2)


def reduced():
    cfg = ModelConfig(
        name="xlstm-smoke", n_layers=6, d_model=64, n_heads=2,
        n_kv_heads=2, d_ff=0, vocab=256, d_head=32,
        xlstm=XLSTMCfg(slstm_every=6, proj_factor=2.0),
    )
    rc = RunConfig(pp=1, vpp=1, microbatches=2, param_dtype="float32",
                   compute_dtype="float32")
    return cfg, rc
