"""Few-shot serving on the GPU for one replica: the counterpart of the JAX
package's ``serving/``.

* ``registry`` — TenantRegistry: per-tenant support sets distilled once to
  resident [N, C] class matrices (f32, bf16 or int8; padded to N tiers),
  published as copy-on-write ``Snapshot``s over a shared slot pool, with
  hot-swap publish on two parameter banks and quarantine.
* ``buckets``  — fixed batch buckets, and the ``QueryGraphCache``: one
  CUDA graph of ``score_queries`` per (n_tier, bucket, dtype) and bank.
* ``batcher``  — ContinuousBatcher (default) and DynamicBatcher, with
  deadlines and shed-load.
* ``geometry`` — the N-tier ladder; ``breaker`` — per-tenant circuit
  breaker; ``stats`` — ServingStats.
* ``engine``   — InferenceEngine: submit/classify/publish behind the above,
  with the FewRel 2.0 NOTA "no_relation" verdict under per-tenant
  thresholds.
* ``cli``      — ``python -m induction_network_on_fewrel_tpu_torch.serving.cli``
  (``serve_main``).
"""

from induction_network_on_fewrel_tpu_torch.serving.batcher import (  # noqa: F401
    ContinuousBatcher,
    DeadlineExceeded,
    DynamicBatcher,
    ExecuteError,
    Saturated,
)
from induction_network_on_fewrel_tpu_torch.serving.buckets import (  # noqa: F401
    DEFAULT_BUCKETS,
    QueryGraphCache,
    QueryRunner,
    pad_rows,
    select_bucket,
    stack_queries,
)
from induction_network_on_fewrel_tpu_torch.serving.engine import (  # noqa: F401
    InferenceEngine,
)
from induction_network_on_fewrel_tpu_torch.serving.registry import (  # noqa: F401
    DEFAULT_TENANT,
    ClassVectorRegistry,
    PublishError,
    Snapshot,
    TenantRegistry,
)
from induction_network_on_fewrel_tpu_torch.serving.stats import (  # noqa: F401
    ServingStats,
)
