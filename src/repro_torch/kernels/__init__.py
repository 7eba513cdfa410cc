"""Kernels of the port: plain versions (``ref``), the CUDA kernels
(``csrc``, built by ``build``, wrapped in ``paged_attention``,
``flash_attention`` and ``fused_xent``) and the dispatch between them
(``ops``)."""
