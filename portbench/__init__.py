"""The benchmark of ``ray_tpu_torch`` on an NVIDIA H100.

``python -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once. Everything a cell
needs is found by name: its configuration in ``configs/``, its traffic mix
in ``traffic/``, the limits of its correctness check in ``limits/`` and each
per-layer metric's reader in ``metrics/``. ``README.md`` says how to add
one.

Nothing here imports ``jax`` or the JAX package ``ray_tpu``; the plain
reference in ``reference/`` imports nothing of ``ray_tpu_torch`` either.
"""
