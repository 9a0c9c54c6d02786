"""Runtime of the port: the index/query serving API (mutable and durable),
join sessions, and the host-side serving stack — fault injection, the
straggler detector, the step supervisor, the sub-query fault policy and
the overload-robust ``KNNServer`` front end — and the sharded index over a
slot mesh (``ShardedKNNIndex``)."""
from repro_torch.runtime.faults import (
    Arrival, CheckpointCrash, CrashingCheckpointManager, FaultInjector,
    ScriptedFaults, SubQueryFault, VirtualClock, open_loop_trace,
)
from repro_torch.runtime.knn_index import (
    KNNIndex, clear_engine_cache, validate_k, validate_points,
)
from repro_torch.runtime.server import (
    BatchRecord, DegradationLevel, KNNServer, Rejected, Served,
    ServerConfig, Ticket,
)
from repro_torch.runtime.serving import (
    ServingConfig, ServingSupervisor, SubQueryOutcome,
)
from repro_torch.runtime.session import JoinSession
from repro_torch.runtime.sharded_index import ShardedKNNIndex
from repro_torch.runtime.stragglers import (
    OnlineRho, StragglerConfig, StragglerDetector, suggest_rho,
)
from repro_torch.runtime.supervisor import RunReport, Supervisor, SupervisorConfig

__all__ = [
    "KNNIndex", "ShardedKNNIndex", "JoinSession", "clear_engine_cache",
    "validate_points", "validate_k",
    "KNNServer", "ServerConfig", "DegradationLevel", "Served", "Rejected",
    "Ticket", "BatchRecord",
    "ServingConfig", "ServingSupervisor", "SubQueryOutcome",
    "FaultInjector", "ScriptedFaults", "SubQueryFault",
    "CrashingCheckpointManager", "CheckpointCrash",
    "VirtualClock", "Arrival", "open_loop_trace",
    "StragglerConfig", "StragglerDetector", "suggest_rho", "OnlineRho",
    "RunReport", "Supervisor", "SupervisorConfig",
]
