"""jamba-v0.1-52b — 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536.

[arXiv:2403.19887; hf] Mamba+attention 1:7 interleave (attention at layer
index 4 of each period-8 block), MoE 16e top-2 on odd layers, untied head.
Same values as ``repro/configs/jamba_v0p1_52b.py``.

One period of eight layers holds every layer kind of the model:
``mamba:dense`` (layers 0, 2, 6), ``mamba:moe`` (1, 3, 5, 7) and
``attn:dense`` (4). The port serves one period on one card
(``one_card_config()``) and trains a two-layer cut of it
(``one_card_train_config()``, ``one_card_train_run()``).
"""

import dataclasses

from repro_torch.configs._base import one_card, one_card_train
from repro_torch.models.common import MambaCfg, MoECfg, ModelConfig, RunConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b", n_layers=32, d_model=4096, n_heads=32,
        n_kv_heads=8, d_ff=14336, vocab=65536, d_head=128,
        mamba=MambaCfg(d_state=16, d_conv=4, expand=2),
        attn_every=8, attn_offset=4,
        moe=MoECfg(n_experts=16, top_k=2, d_ff_expert=14336, every=2,
                   offset=1),
    )


def one_card_config() -> ModelConfig:
    """The published widths at depth 8 (one full period), for one card.

    The only cut is depth, 32 -> 8: the 32 layers hold 51.6 B parameters,
    103 GB in bf16, more than the card's 80 GB. One period plus the
    embedding and the head is 13.30 B parameters (26.6 GB in bf16) and
    keeps every layer kind in its published ratio. Widths are not cut.
    """
    return dataclasses.replace(config(), n_layers=8)


def one_card_run() -> RunConfig:
    return one_card()


# the one-card training shape: one 4096-token sequence a micro-batch,
# four micro-batches (16,384 tokens a step)
TRAIN_SEQ, TRAIN_BATCH = 4096, 4


def one_card_train_config() -> ModelConfig:
    """The published widths trained on one card: two cuts.

    Widths are not cut: d_model 4096, d_ff and d_ff_expert 14336, d_state
    16, d_conv 4, expand 2, dt_rank 256 (d_model / 16), vocab 65536,
    top-2 routing at capacity factor 1.25, an untied head.

    * Depth 32 -> 2: layer 0 is ``mamba:dense``, layer 1 ``mamba:moe``,
      the first depth that holds a MoE layer (the attention layer, index
      4, is left out; training runs attention in the llama and gpt
      cells).
    * Experts 16 -> 8 (top-2 kept). A ``mamba:moe`` layer of 16 experts
      holds 2.82 B parameters (16 x 3 x 4096 x 14336); with the io (the
      embedding and the untied head, 2 x 65536 x 4096 = 0.54 B), two
      Mamba mixers (0.105 B each) and the dense FFN (0.176 B) that is
      3.74 B, and at the port's 18-22 bytes a parameter (bf16 params,
      float32 master weights, moments, gradients and ``acc_full``)
      67-82 GB before activations: more than the card's 80 GB. Eight
      experts give 2.33 B parameters, 42-51 GB.
    """
    cfg = config()
    return dataclasses.replace(
        cfg, n_layers=2, moe=dataclasses.replace(cfg.moe, n_experts=8))


def one_card_train_run() -> RunConfig:
    """zeropp at pp 1 over the two layers as one stage block (vpp 1: at
    depth 2 the static-kinds rule allows no vpp 2, whose stage blocks
    would hold a dense and a MoE layer in the same slot), four
    micro-batches of one 4096-token sequence in units of two; bf16 params
    and compute, float32 master weights and moments."""
    return one_card_train(vpp=1)


def reduced():
    cfg = ModelConfig(
        name="jamba-smoke", n_layers=8, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=256, d_head=16,
        mamba=MambaCfg(d_state=4, d_conv=4, expand=2),
        attn_every=8, attn_offset=4,
        moe=MoECfg(capacity_factor=8.0, n_experts=4, top_k=2,
                   d_ff_expert=128, every=2, offset=1),
    )
    rc = RunConfig(pp=1, vpp=1, microbatches=2, param_dtype="float32",
                   compute_dtype="float32")
    return cfg, rc
