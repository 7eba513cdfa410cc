"""repro_torch — the PyTorch/CUDA port of ``repro``, for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package grows beside it
slice by slice and imports nothing of it (nor jax). It trains dense
attention models on one card through the ZeroPP tick engine (Session
``mode="train"``, ``launch/train.py``) and serves them, and the Jamba
hybrid (Mamba, attention and gathered-MoE layers), through its
ServeEngine (``launch/serve.py``); the attention, the vocabulary loss and
the selective scan run on hand-written CUDA kernels (``kernels/csrc``).
Entry points run on the card unless the caller asks for ``device="cpu"``.
"""

from repro_torch.api import session

__all__ = ["session"]
