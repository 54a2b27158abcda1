"""Collectives of the port: the device plane (``xla``), in-program
collectives over ``torch.distributed``. The actor-level group API of the
JAX package (``collective/collective.py``) comes with the runtime core."""

from ray_tpu_torch.collective import xla

__all__ = ["xla"]
