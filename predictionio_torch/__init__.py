"""predictionio_torch — the PyTorch / CUDA port of predictionio_tpu.

The same machine-learning server framework (DASE engines, model
persistence, REST serving), with its compute on an NVIDIA Hopper card:
plain tensor code is PyTorch, and every kernel the JAX package wrote in
Pallas for the TPU is a hand-written CUDA kernel under
``ops/kernels/csrc/``, built with ``nvcc`` at first use.

The package imports ``torch``, ``numpy`` and the standard library only —
never ``jax`` and nothing of ``predictionio_tpu``. Where it needs a
jax-free module of the old package it keeps its own trimmed copy under
the same module path, so ``predictionio_tpu/index/exact.py`` has its
counterpart at ``predictionio_torch/index/exact.py``.

Entry points run on the card: ``DeviceContext()`` means ``cuda:0`` and
raises when CUDA is absent, unless the caller asks for ``device="cpu"``
(the tests do) or passes ``--device cpu`` to the CLI.

Ported so far: ``pio deploy`` of the Recommendation (ALS) and two-tower
engines — loading a trained instance (JAX-trained blobs included) and
answering ``POST /queries.json`` through the ``topk_dot`` kernel — and
``pio train`` of the two-tower engine from the event store, through the
``flash_ce`` (loss forward and backward) and ``embed_update`` (table
update) kernels, and ``pio train`` of the Recommendation (ALS) engine
(``ops/als.py``: the segmented layout, the gather+Gramian half-step and
the Jacobi CG solve in PyTorch). What remains is in ROADMAP.md.
"""

__version__ = "0.1.0"
