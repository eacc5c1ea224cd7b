"""Serving stack of the port: the continuous-batching engine over the
paged KV cache, with its requests, queue, slot scheduler and speculative
decoding proposers."""
from .engine import Engine  # noqa: F401
from .kvcache import BlockPool, NoFreeBlocks, PrefixCache  # noqa: F401
from .request import (  # noqa: F401
    DeadlineShed, QueueFull, RateLimited, Rejected, Request, RequestQueue,
    RequestTimeout, TenantPolicy, TokenBucket,
)
from .scheduler import Scheduler, Slot  # noqa: F401
from .spec import (  # noqa: F401
    DraftModelProposer, PromptLookupProposer, Proposer,
)
