"""repro_torch — the PyTorch/CUDA port of ``repro``, for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package grows beside it
slice by slice and imports nothing of it (nor jax). It serves dense
attention models through its own Session, ServeEngine and
``launch/serve.py``, with the serving attention on two hand-written CUDA
kernels (``kernels/csrc``). Entry points run on the card unless the
caller asks for ``device="cpu"``.
"""

from repro_torch.api import session

__all__ = ["session"]
