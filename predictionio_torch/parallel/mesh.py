"""The JAX package's ``parallel.mesh`` name, for one device per process.

Engine code written against the JAX package — a project that its ``pio
template get`` scaffolded, which the port's project loader runs with its
imports rewritten to ``predictionio_torch`` (``workflow/variant.py``) —
types its context as ``MeshContext``. Here that is the port's
:class:`~predictionio_torch.parallel.context.DeviceContext`: one device,
no mesh. Meshes and sharding wait for ROADMAP.md queue 1 item 12.
"""

from predictionio_torch.parallel.context import DeviceContext

MeshContext = DeviceContext

__all__ = ["MeshContext"]
