"""Request-oriented serving: the continuous-batching ``Engine`` over
block-paged quantized KV pools, its request types, and arrival traces."""
from repro_torch.serving.engine import (  # noqa: F401
    Engine,
    EngineSaturated,
    EngineStuck,
    RequestOutput,
    SamplingParams,
    ServeRequest,
)
from repro_torch.serving.paged import (  # noqa: F401
    PageAccountingError,
    PageAllocatorExhausted,
    PagedPools,
)
from repro_torch.serving.trace import poisson_trace, run_trace  # noqa: F401
