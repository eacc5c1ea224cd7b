"""Serving stack of the port: the continuous-batching engine over the
paged KV cache, with its requests, queue, slot scheduler, speculative
decoding proposers, LoRA adapter lanes, token streams and the host-RAM
KV offload tier."""
from .engine import Engine  # noqa: F401
from .kvcache import (  # noqa: F401
    BlockPool, KVDtypeMismatch, NoFreeBlocks, PrefixCache, export_blocks,
    import_blocks, payload_from_json, payload_to_json,
)
from .lora import (  # noqa: F401
    AdapterInUse, AdapterRegistry, LoRAAdapter, RegistryFull,
    UnknownAdapter,
)
from .offload import HostBlockStore, prefix_key  # noqa: F401
from .quant import QuantKV, relayout_weights_int8  # noqa: F401
from .request import (  # noqa: F401
    DeadlineShed, QueueFull, RateLimited, Rejected, Request, RequestQueue,
    RequestTimeout, TenantPolicy, TokenBucket,
)
from .scheduler import Scheduler, Slot  # noqa: F401
from .spec import (  # noqa: F401
    DraftModelProposer, PromptLookupProposer, Proposer,
)
from .stream import (  # noqa: F401
    StreamClosed, StreamEvent, TokenStream, parse_sse, sse_format,
)

__all__ = [
    "Request", "RequestQueue", "RequestTimeout", "QueueFull", "Rejected",
    "RateLimited", "DeadlineShed", "TenantPolicy", "TokenBucket",
    "Scheduler", "Slot", "Engine",
    "BlockPool", "PrefixCache", "NoFreeBlocks",
    "KVDtypeMismatch", "QuantKV", "relayout_weights_int8",
    "export_blocks", "import_blocks", "payload_to_json", "payload_from_json",
    "HostBlockStore", "prefix_key",
    "Proposer", "PromptLookupProposer", "DraftModelProposer",
    "LoRAAdapter", "AdapterRegistry", "AdapterInUse", "RegistryFull",
    "UnknownAdapter",
    "TokenStream", "StreamEvent", "StreamClosed", "sse_format", "parse_sse",
]
