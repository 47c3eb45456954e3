"""Checkpointing in the JAX package's on-disk format."""
from .checkpoint import (latest_step, restore, save,  # noqa: F401
                         wait_for_async_saves)
