"""Serving stack of the port: the continuous-batching engine over the
paged KV cache, with its requests, queue, slot scheduler, speculative
decoding proposers, LoRA adapter lanes, token streams, the host-RAM KV
offload tier and KV migration; the fault injector and tick watchdog;
and the front ends: the replica's HTTP server (``httpd``), the
multi-replica router and its HTTP front door (``router``,
``routerd``), and the self-healing fleet supervisor (``supervisor``)."""
from .request import (  # noqa: F401
    DeadlineShed, QueueFull, RateLimited, Rejected, Request, RequestQueue,
    RequestTimeout, TenantPolicy, TokenBucket,
)
from .scheduler import Scheduler, Slot  # noqa: F401
from .kvcache import (  # noqa: F401
    BlockPool, KVDtypeMismatch, NoFreeBlocks, PrefixCache, export_blocks,
    import_blocks, payload_from_json, payload_to_json,
)
from .quant import QuantKV, relayout_weights_int8  # noqa: F401
from .spec import (  # noqa: F401
    DraftModelProposer, PromptLookupProposer, Proposer,
)
from .faults import (  # noqa: F401
    FaultInjector, InjectedFault, NetDisconnect, NetFault, NetRefused,
    NetTimeout, TickWatchdog, WatchdogTimeout,
)
from .lora import (  # noqa: F401
    AdapterInUse, AdapterRegistry, LoRAAdapter, RegistryFull,
    UnknownAdapter,
)
from .stream import (  # noqa: F401
    StreamClosed, StreamEvent, TokenStream, parse_sse, sse_format,
)
from .offload import HostBlockStore, prefix_key  # noqa: F401
from .engine import Engine  # noqa: F401
from .httpd import EngineServer, serve  # noqa: F401
from .router import (  # noqa: F401
    CircuitBreaker, HttpReplicaClient, InProcessReplica,
    NoReplicasAvailable, Replica, ReplicaAbandoned, ReplicaHTTPError,
    ReplicaUnavailable, RequestFailed, Router, RouterError, RouterPolicy,
    UnknownModel, affinity_key,
)
from .routerd import RouterServer  # noqa: F401
from .supervisor import (  # noqa: F401
    FleetSupervisor, ProcessReplica, SupervisorPolicy, supervise_fleet,
)

__all__ = [
    "Request", "RequestQueue", "RequestTimeout", "QueueFull",
    "Rejected", "RateLimited", "DeadlineShed", "TenantPolicy",
    "TokenBucket",
    "Scheduler", "Slot", "Engine", "EngineServer", "serve",
    "BlockPool", "PrefixCache", "NoFreeBlocks",
    "KVDtypeMismatch", "QuantKV", "relayout_weights_int8",
    "export_blocks", "import_blocks", "payload_to_json", "payload_from_json",
    "HostBlockStore", "prefix_key",
    "Proposer", "PromptLookupProposer", "DraftModelProposer",
    "FaultInjector", "InjectedFault", "TickWatchdog",
    "WatchdogTimeout",
    "NetFault", "NetRefused", "NetTimeout", "NetDisconnect",
    "LoRAAdapter", "AdapterRegistry", "AdapterInUse", "RegistryFull",
    "UnknownAdapter",
    "TokenStream", "StreamEvent", "StreamClosed", "sse_format",
    "parse_sse",
    "Router", "RouterPolicy", "RouterServer", "RouterError",
    "UnknownModel",
    "NoReplicasAvailable", "RequestFailed", "Replica",
    "ReplicaAbandoned", "ReplicaHTTPError", "ReplicaUnavailable",
    "CircuitBreaker", "HttpReplicaClient", "InProcessReplica",
    "affinity_key",
    "FleetSupervisor", "SupervisorPolicy", "ProcessReplica",
    "supervise_fleet",
]
