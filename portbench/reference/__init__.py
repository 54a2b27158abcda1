"""The plain reference: the models, their loss and the optimizer in fp32
PyTorch with TF32 off, written from the models' equations. It imports
nothing of ``ray_tpu_torch`` (nor ``jax`` or ``ray_tpu``); it takes its
weights and inputs from ``portbench.weights`` and ``portbench.feed``, as
the program does, and works out everything else again.

``precision.Precision("fp8")`` is the control: the same reference with the
operands of every product rounded to fp8 (e4m3), the precision below the
bf16 that the configurations state."""
