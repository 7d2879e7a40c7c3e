"""The JAX package's ``parallel.multihost`` process count.

``process_count`` is what engine code written against the JAX package
asks (its recommendation template declines the native binned read when
more than one process trains); here it reads an initialized
``torch.distributed`` world, and one process otherwise.
Multi-process training itself waits for ROADMAP.md queue 1 item 12.
"""

import torch.distributed as dist


def process_count() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1
