"""graftcheck: the repo-native concurrency & RPC-surface static
analysis suite. See core.py for the framework and
ray_tpu_torch/docs/static_analysis.md for the conventions.

Programmatic entry point::

    from ray_tpu_torch.devtools.analysis import run_analysis
    unsuppressed, all_findings = run_analysis(["ray_tpu_torch/"])

CLI::

    python -m ray_tpu_torch.devtools.analysis ray_tpu_torch/
"""

from ray_tpu_torch.devtools.analysis.core import (  # noqa: F401
    Baseline,
    Finding,
    default_baseline_path,
    run_analysis,
)
