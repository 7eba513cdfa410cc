"""jamba-v0.1-52b — 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536.

[arXiv:2403.19887; hf] Mamba+attention 1:7 interleave (attention at layer
index 4 of each period-8 block), MoE 16e top-2 on odd layers, untied head.
Same values as ``repro/configs/jamba_v0p1_52b.py``.

One period of eight layers holds every layer kind of the model:
``mamba:dense`` (layers 0, 2, 6), ``mamba:moe`` (1, 3, 5, 7) and
``attn:dense`` (4).
"""

import dataclasses

from repro_torch.configs._base import one_card
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
