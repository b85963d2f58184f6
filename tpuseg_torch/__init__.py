"""tpuseg_torch — the PyTorch + CUDA port of tpuseg.

The JAX package ``tpuseg`` is the reference each module here is held
against (``tests/test_torch_*.py``). The layout mirrors it: ``core/``,
``nn/``, ``ops/``, ``models/``, ``weights/``, ``engine/``, ``tools/``;
hand-written CUDA kernels live in ``csrc/`` and their Python bindings in
``kernels/``. This package never imports jax.
"""
