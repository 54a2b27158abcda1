"""graftsan — graftcheck's declared contracts, enforced at runtime.

Opt-in only: ``RTPU_SANITIZE=1`` makes ``import ray_tpu_torch`` install the
instrumented lock factories and arm the guarded-attribute
descriptors, driven by the manifest graftcheck emits
(``python -m ray_tpu_torch.devtools.analysis --emit-contracts``). With the
env var unset this package is never imported — zero overhead, not
"cheap" overhead (the tier-1 suite asserts
``"ray_tpu_torch.devtools.sanitizer" not in sys.modules``).

See ray_tpu_torch/docs/static_analysis.md §13 for the model.
"""

from __future__ import annotations

import os

from ray_tpu_torch.devtools.sanitizer.report import (  # noqa: F401
    Reporter,
    Violation,
    read_log,
    reporter,
)
from ray_tpu_torch.devtools.sanitizer.runtime import (  # noqa: F401
    arm,
    arm_class,
    check_blocking,
    disarm,
    install,
    installed,
    observed_pairs,
    uninstall,
    wrap_blocking,
)


def enabled() -> bool:
    return os.environ.get("RTPU_SANITIZE") == "1"
