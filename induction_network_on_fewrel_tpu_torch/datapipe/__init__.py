"""The host feed: a pipelined, checkpointable episode input pipeline.

The port's counterpart of ``induction_network_on_fewrel_tpu/datapipe/``:

* ``producer``: ``PipelineFeed``, a producer thread that drives a sampler
  into a bounded queue so host sampling overlaps the card's step;
  ``prefetch_depth=0`` is the synchronous path, bitwise;
* ``cursor``: ``PipelineCursor``, the stream position every checkpoint
  carries, so a resume replays the exact episode stream at any depth;
* ``mixture``: episode-mixture schedules resolved from (seed, batch index);
* ``faults``: feed fault injection (slow, stall, poison) and query-side
  perturbations.
"""

from induction_network_on_fewrel_tpu_torch.datapipe.cursor import (  # noqa: F401
    PipelineCursor,
    capture_sampler_state,
    restore_sampler_state,
)
from induction_network_on_fewrel_tpu_torch.datapipe.faults import FeedFaults  # noqa: F401
from induction_network_on_fewrel_tpu_torch.datapipe.mixture import (  # noqa: F401
    MixtureSampler,
    MixtureSchedule,
)
from induction_network_on_fewrel_tpu_torch.datapipe.producer import (  # noqa: F401
    FeedError,
    PipelineFeed,
)
