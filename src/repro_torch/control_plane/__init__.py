"""Out-of-process anchor control plane: worker-per-shard processes
behind an RPC layer with deadlines, bounded retries, exponential
backoff, and chaos-tested crash recovery.

- ``rpc``      — transport protocol, retry/backoff channel, injectable clocks
- ``worker``   — ``ShardHost`` command surface + process entry + transports
- ``registry`` — ``ProcessShardedRegistry``, the composer (the drop-in
  process-backed ``ShardedAnchorRegistry``)

Port of ``repro.control_plane``, copied verbatim except for its imports: it
holds no JAX, and the port keeps its own copy rather than importing the
reference.
"""
from repro_torch.control_plane.registry import (           # noqa: F401
    ControlPlaneHealth,
    ProcessShardedRegistry,
)
from repro_torch.control_plane.rpc import (                # noqa: F401
    Clock,
    FakeClock,
    RpcChannel,
    RpcPolicy,
    RpcRemoteError,
    RpcStats,
    RpcTimeout,
    SystemClock,
    WorkerDown,
)
from repro_torch.control_plane.worker import (             # noqa: F401
    LoopbackTransport,
    ProcWorker,
    ShardHost,
    worker_main,
)
