"""Few-shot serving on the GPU: the synchronous core of the JAX package's
``serving/`` (registry, buckets, engine) and its demo CLI.

* ``registry`` — TenantRegistry: per-tenant support sets distilled once to
  resident [N, C] class matrices, published as immutable snapshots.
* ``buckets``  — fixed batch buckets, row-0 padding, the eager QueryRunner.
* ``engine``   — InferenceEngine: register, classify, classify_batch, and
  the FewRel 2.0 NOTA "no_relation" verdict under per-tenant thresholds.
* ``cli``      — ``python -m induction_network_on_fewrel_tpu_torch.serving.cli``.
"""

from induction_network_on_fewrel_tpu_torch.serving.buckets import (  # noqa: F401
    DEFAULT_BUCKETS,
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
    Snapshot,
    TenantRegistry,
)
