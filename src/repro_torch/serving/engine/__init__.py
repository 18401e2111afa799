"""Event-driven fleet serving engine (DESIGN.md §8/§10): continuous-time
arrivals, multi-server queues, device segment-cache state, pluggable
admission policies, fleet metrics — plus the operational-resilience
layer: fault injection (device churn, channel degradation), retry with
dead-letter queue, replayable event journal, MMPP/diurnal traces — and
the scale core (DESIGN.md §12): bulk-loaded arrivals, columnar records,
vectorized admission and selectable journaling modes."""
from repro_torch.serving.engine.events import (DECODE_STEP, ArrivalStream,  # noqa: F401
                                               Event, EventQueue, StageTimeline)
from repro_torch.serving.engine.faults import (DEGRADE,  # noqa: F401
                                               DISCONNECT, RECONNECT, FaultEvent,
                                               FaultInjector, churn_trace,
                                               degrade_trace)
from repro_torch.serving.engine.fleet import (FleetEngine,  # noqa: F401
                                              ServerState)
from repro_torch.serving.engine.journal import (JOURNAL_MODES,  # noqa: F401
                                                EventJournal, JournalEntry,
                                                LightJournal)
from repro_torch.serving.engine.metrics import (FleetMetrics,  # noqa: F401
                                                FleetRecord)
from repro_torch.serving.engine.records import (LazyRecords,  # noqa: F401
                                                RecordStore)
from repro_torch.serving.engine.policies import (POLICIES,  # noqa: F401
                                                 AdmissionPolicy, BalancedPolicy,
                                                 EDFPolicy, FCFSPolicy,
                                                 LeastLoadedPolicy, get_policy)
from repro_torch.serving.engine.retry import (DROP_REASONS,  # noqa: F401
                                              REASON_ABANDONED, REASON_EXHAUSTED,
                                              REASON_SLO, DeadLetter, RetryPolicy)
from repro_torch.serving.engine.traces import (diurnal_arrivals,  # noqa: F401
                                               materialize, mmpp_arrivals)
