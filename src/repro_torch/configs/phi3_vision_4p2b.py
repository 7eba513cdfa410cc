"""phi-3-vision-4.2b — 32L d_model=3072 32H (GQA kv=32) d_ff=8192 vocab=32064.

[hf:microsoft/Phi-3-vision-128k-instruct; hf] phi3-mini backbone + CLIP
frontend. As in the reference, the vision tower is a stub: the batch's
``tokens`` are precomputed patch embeddings, float [b, s, d_model], fed to
the first stage in place of the token embedding (``frontend="vision"``).
Same values as ``repro/configs/phi3_vision_4p2b.py``.

Counts from the ParamSpecs: a layer holds 113,252,352 parameters
(37,748,736 in attention, 75,497,472 in the SwiGLU FFN, 6,144 in the
norms); the embedding, the final norm and the untied head 197,004,288
more (the table takes no gradient from a float batch, as in the
reference). 32064 is not a multiple of K2's 128-column vocabulary tile:
its last tile holds 64 columns.
"""

import dataclasses

from repro_torch.configs._base import one_card, one_card_train
from repro_torch.models.common import ModelConfig, RunConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b", n_layers=32, d_model=3072, n_heads=32,
        n_kv_heads=32, d_ff=8192, vocab=32064, d_head=96,
        frontend="vision",
    )


def one_card_run() -> RunConfig:
    """Serving at full width and depth: 3,821,079,552 parameters,
    7,642,159,104 bytes of bf16 weights; at 8 slots of 2048 positions the
    bf16 KV cache takes 6,442,450,944 bytes more (32 layers x 2 x 32 kv
    heads x 96)."""
    return one_card()


# the one-card training shape: one 4096-position sequence a micro-batch,
# four micro-batches (16,384 float-embedding positions a step)
TRAIN_SEQ, TRAIN_BATCH = 4096, 4


def one_card_train_config() -> ModelConfig:
    """The published widths trained on one card: one cut, depth 32 -> 16.

    Widths are not cut: d_model 3072, 32 heads of 96 (MHA), d_ff 8192,
    vocab 32064, an untied head. At full depth the 3.82 B parameters need
    68.8-84.1 GB at the port's 18-22 bytes a parameter (bf16 params,
    float32 master weights, moments, gradients and ``acc_full``) before
    any activation, beside 4 x 4096 x 3072 float32 patch embeddings a
    step. Sixteen layers are 1,812,037,632 parameters and the io
    197,004,288: 2,009,041,920 in all, 36.2-44.2 GB before activations.
    """
    return dataclasses.replace(config(), n_layers=16)


def one_card_train_run() -> RunConfig:
    """The port's one-card training layout: zeropp at pp 1 with the stage
    blocks interleaved (vpp 2, eight layers a block), four micro-batches
    of one 4096-position sequence in units of two; bf16 params and
    compute, float32 master weights and moments."""
    return one_card_train()


def reduced():
    cfg = ModelConfig(
        name="phi3v-smoke", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=256, d_head=16, frontend="vision",
    )
    rc = RunConfig(pp=2, vpp=2, microbatches=2, param_dtype="float32",
                   compute_dtype="float32")
    return cfg, rc
