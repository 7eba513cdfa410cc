"""whisper-large-v3 — enc-dec 32+32L d_model=1280 20H d_ff=5120 vocab=51866.

[arXiv:2212.04356; unverified] Same values as
``repro/configs/whisper_large_v3.py``: an encoder-decoder with LayerNorm
and the GELU MLP; a bidirectional encoder over 1500 audio frames and a
causal decoder whose layers add cross-attention over the encoder's
output (the memory). The conv frontend is the reference's stub: the
inputs are precomputed frame embeddings [b, 1500, d] (``enc_tokens``).

Counts from the ParamSpecs: an encoder layer holds 19,665,920 parameters
(two LayerNorms, attention 20 heads of 64, the GELU MLP of 5120), a
decoder layer 26,222,080 (a third LayerNorm and the cross-attention
besides); the embedding, the final norm and the untied head 132,779,520
more (``head.w`` [1280, 51866], whose rows are 103,732 bytes: 4-byte
aligned, not 16). 1,601,195,520 in all: the port serves and trains all
64 layers at full width on one card, cut only in the batch.
"""

from repro_torch.configs._base import one_card, one_card_train
from repro_torch.models.common import EncDecCfg, ModelConfig, RunConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3", n_layers=32, d_model=1280, n_heads=20,
        n_kv_heads=20, d_ff=5120, vocab=51866, d_head=64,
        norm="layernorm", act="gelu_mlp",
        encdec=EncDecCfg(enc_layers=32, enc_ctx=1500),
        frontend="audio",
    )


def one_card_config() -> ModelConfig:
    """The published model, uncut (1,601,195,520 parameters: 3.2 GB of
    bf16 weights)."""
    return config()


def one_card_train_config() -> ModelConfig:
    """The published model, uncut: 28.8-35.2 GB of training state at the
    port's 18-22 bytes a parameter before activations."""
    return config()


def one_card_run() -> RunConfig:
    """Serving at full width and depth on one rank: the decoder's 32
    stages walked in order, the memory [slots, 1500, 1280] a leaf of the
    cache tree (``enc_memory``)."""
    return one_card()


# the one-card training shape: whisper's decoder context of 448 tokens,
# two sequences (each with its 1500 frames) a micro-batch, four
# micro-batches (3,584 decoder tokens and 12,000 frames a step): the only
# cut, the batch
TRAIN_SEQ, TRAIN_BATCH = 448, 8


def one_card_train_run() -> RunConfig:
    """zeropp at pp 1: each segment one layer a stage (V = 32 stages
    each), four micro-batches in units of two; bf16 params and compute,
    float32 master weights and moments. The encoder runs forward for
    every micro-batch first, the decoder's table next, the encoder's
    backward (the table's B and W tasks) last."""
    return one_card_train(vpp=1)


def reduced():
    cfg = ModelConfig(
        name="whisper-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=256, d_head=16,
        norm="layernorm", act="gelu_mlp",
        encdec=EncDecCfg(enc_layers=2, enc_ctx=16), frontend="audio",
    )
    rc = RunConfig(pp=2, vpp=1, microbatches=2, param_dtype="float32",
                   compute_dtype="float32")
    return cfg, rc
