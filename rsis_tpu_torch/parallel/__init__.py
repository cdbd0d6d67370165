"""Data-parallel training over processes, one a device (``distributed``,
``mesh``), and the collectives of the global-batch step and of the
H-sharded streaming forward."""

from . import distributed  # noqa: F401
from .distributed import global_batch_slice, initialize, shutdown  # noqa: F401
from .mesh import (  # noqa: F401
    Group,
    create_mesh,
    create_multislice_mesh,
    replicate,
    shard_batch,
)
