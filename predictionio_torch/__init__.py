"""predictionio_torch — the PyTorch / CUDA port of predictionio_tpu.

The same machine-learning server framework (DASE engines, model
persistence, REST serving), with its compute on an NVIDIA Hopper card:
plain tensor code is PyTorch, and every kernel the JAX package wrote in
Pallas for the TPU is a hand-written CUDA kernel under
``ops/kernels/csrc/``, built with ``nvcc`` at first use. The host
C++ of the event log and the ALS layout lives under ``native/``, built
with ``g++`` at first use.

The package imports ``torch``, ``numpy`` and the standard library only —
never ``jax`` and nothing of ``predictionio_tpu``. Where it needs a
jax-free module of the old package it keeps its own trimmed copy under
the same module path, so ``predictionio_tpu/index/exact.py`` has its
counterpart at ``predictionio_torch/index/exact.py``.

Entry points run on the card: ``DeviceContext()`` means ``cuda:0`` and
raises when CUDA is absent, unless the caller asks for ``device="cpu"``
(the tests do) or passes ``--device cpu`` to the CLI.

What is ported: ``pio train`` and ``pio deploy`` of every engine the
JAX package ships (Recommendation/ALS, two-tower and the hybrid,
similar product, e-commerce, the session recommender, classification,
regression, vanilla), serving ``POST /queries.json`` through the
``topk_dot`` kernel and training the two-tower tables through the
``flash_ce`` and ``embed_update`` kernels; the native event log's data
lane and the front door (event server, apps, keys, import/export);
``pio eval`` with grid tuning; ``pio stream``; the engine-project path;
the observability plane and the deployed engine's operator contract
(fleet, router, SLOs, chaos, replay); training and serving across
processes; the storage tier (sqlite, the sharded and replicated
``rest`` backends, ``pio storageserver``); and the kernel-library cache,
``pio train``'s profile capture (``PIO_PROFILE_DIR``), the version check
and ``pio bench-compare``. What remains is in ROADMAP.md.
"""

__version__ = "0.1.0"
