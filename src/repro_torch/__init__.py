"""repro_torch — the PyTorch/CUDA port of the CRIU-style checkpoint engine.

Laid out file for file like ``repro`` (the JAX package, which stays the
reference). The port imports ``torch`` and never ``jax``: framework-free
modules of ``repro`` are copied here rather than imported, because
importing any ``repro.core`` module pulls in ``jax.numpy``.

Entry points take an explicit ``device`` (default ``"cuda"``); without a
card they raise unless the caller asks for ``device="cpu"``. The codec
kernels (``kernels/ckpt_codec``) are hand-written CUDA C++ for ``sm_90a``,
built with ``nvcc`` at first use; a CPU tensor goes to their plain torch
versions instead.
"""
