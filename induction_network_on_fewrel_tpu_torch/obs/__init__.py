"""obs/ — the telemetry spine of the port.

The counterpart of ``induction_network_on_fewrel_tpu/obs/`` with the same
module names and exports, except ``AdaptationController`` (``obs/adapt.py``
comes with its ``train/finetune.py`` in a later slice):

* ``spans``    — host-side timed regions in a ring, bridged to NVTX ranges
                 on a CUDA device, with request-scoped trace contexts.
* ``health``   — the run-health watchdog over the metrics stream, the
                 per-tenant SLO burn-rate engine and the diagnostics
                 capture (flight dump, span snapshot, ``torch.profiler``).
* ``drift``    — the online prediction-drift detector over serving verdicts.
* ``perf``     — the per-window step-time decomposition whose segments
                 tile the window.
* ``compile``  — capture forensics: CUDA-graph captures and kernel builds,
                 with the steady-state zero-capture gate.
* ``chaos``    — the named fault points driven by one ``--chaos`` plan.
* ``recorder`` — the flight recorder.
* ``export``   — counters, gauges, histograms and Prometheus text.

``tools/obs_report.py`` (the JAX package's tool) renders and checks a run
directory of either package.
"""

from induction_network_on_fewrel_tpu_torch.obs.chaos import (
    ChaosError,
    ChaosRegistry,
    chaos_active,
    chaos_fire,
    corrupt_step_dir,
)
from induction_network_on_fewrel_tpu_torch.obs.compile import (
    CompileWatcher,
    bind_health,
)
from induction_network_on_fewrel_tpu_torch.obs.drift import DriftDetector
from induction_network_on_fewrel_tpu_torch.obs.export import (
    CounterRegistry,
    Histogram,
    get_registry,
    set_registry,
)
from induction_network_on_fewrel_tpu_torch.obs.health import (
    DiagnosticsCapture,
    HealthEvent,
    HealthWatchdog,
    SLOEngine,
    SLOObjective,
)
from induction_network_on_fewrel_tpu_torch.obs.perf import PerfObserver
from induction_network_on_fewrel_tpu_torch.obs.recorder import FlightRecorder
from induction_network_on_fewrel_tpu_torch.obs.spans import (
    SpanTracker,
    TraceContext,
    TraceSampler,
    get_tracker,
    new_trace_id,
    set_tracker,
    span,
)

__all__ = [
    "ChaosError",
    "ChaosRegistry",
    "chaos_active",
    "chaos_fire",
    "corrupt_step_dir",
    "CompileWatcher",
    "CounterRegistry",
    "DiagnosticsCapture",
    "DriftDetector",
    "FlightRecorder",
    "HealthEvent",
    "HealthWatchdog",
    "Histogram",
    "PerfObserver",
    "SLOEngine",
    "SLOObjective",
    "SpanTracker",
    "TraceContext",
    "TraceSampler",
    "bind_health",
    "get_registry",
    "get_tracker",
    "new_trace_id",
    "set_registry",
    "set_tracker",
    "span",
]
