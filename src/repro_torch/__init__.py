"""EmptyHeaded on PyTorch and CUDA: the port of the ``repro`` package.

``repro_torch`` imports torch and never jax, and nothing of ``repro``;
its layout mirrors ``repro`` (``core/``, ``kernels/<name>/``, ``graph/``,
``data/``) so each module's counterpart is easy to find.  The kernels'
CUDA sources live in ``csrc/`` and are built at first use.
"""
