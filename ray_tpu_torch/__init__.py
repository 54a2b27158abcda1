"""ray_tpu_torch: the PyTorch and CUDA port of ray_tpu, for NVIDIA Hopper.

It imports torch, never jax, and nothing of ``ray_tpu``. Module names
mirror the JAX package's, so each has its counterpart there.

Ported so far: the flagship transformer's forward (``models.transformer``)
and training step (``models.training``), with attention through
hand-written CUDA flash-attention kernels (``ops.flash_attention``): the
forward in ``csrc/flash_attention.cu``, the dQ and dK/dV backward in
``csrc/flash_attention_bwd.cu``; and the scheduler's device programs
(``_private.scheduler``: the class-fill policy and the placement-group
packer) as CUDA kernels in ``csrc/scheduler.cu``; the mesh layer
(``parallel``: meshes, slice meshes, multi-host process groups, the
pipeline over ``pp``; ``collective.xla``; the sharded train step of
``models.sharded``); and the ViT family (``models.vit``). The runtime is
still to come.
"""
