"""Serving attention of the port: plain versions (``ref``), the CUDA
kernels (``csrc``, built by ``build``, wrapped in ``paged_attention``) and
the dispatch between them (``ops``)."""
