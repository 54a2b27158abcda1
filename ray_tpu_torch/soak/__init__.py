"""Production soak plane (ROADMAP item 5): the whole cast — async
HTTP ingress with streaming, the batched+multiplexed serve plane, a
data-fed checkpointing multi-slice trainer, and a normal-task/actor
churn lane — runs *concurrently* under a seeded, time-phased chaos
schedule drawn over the machine-checked chaos-point registry, while
an invariant oracle continuously asserts the documented contracts.

Counterpart of ``ray_tpu/soak/``; the head runs on the card-owning
runtime unless the caller asks for the CPU. Entry points::

    python -m ray_tpu_torch.soak --seed 7 --duration 30      # on the card
    python -m ray_tpu_torch.soak --seed 7 --duration 30 --device cpu
    python -m ray_tpu_torch.soak --seed 7 --duration 30 --dry-run
                                                       # schedule only

See ``ray_tpu_torch/docs/soak.md`` for the schedule grammar, the invariant
table, and the replay contract (same seed => byte-identical fault-event
digest).
"""

from ray_tpu_torch.soak.schedule import (   # noqa: F401
    DIGEST_KINDS,
    Phase,
    Schedule,
    fault_log_digest,
    generate_schedule,
)
from ray_tpu_torch.soak.oracle import (     # noqa: F401
    InvariantResult,
    SoakVerdict,
    gauge_samples,
    gauge_value,
    serve_settle_probe,
    wait_settled,
)
from ray_tpu_torch.soak.runner import SoakConfig, SoakRunner   # noqa: F401
