"""Kernels of the port: plain versions (``ref``), the CUDA kernels
(``csrc``, built by ``build``, wrapped in ``paged_attention``,
``flash_attention``, ``fused_xent`` and ``selective_scan``) and the
dispatch between them (``ops``)."""
