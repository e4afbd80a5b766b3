"""Distributed runtime: Manager-Worker demand-driven dispatch behind the
transport-agnostic WorkerBackend boundary (threads, RPC worker processes or
TCP socket workers), hierarchical storage (with the object-store tier),
fault tolerance (heartbeats/retry/backup tasks) and the paper-scale cluster
simulator. Elastic scaling (the reference's ``runtime/elastic.py``) is not
part of it yet."""

from repro_torch.runtime.fairshare import FairQueue, TaskCancelled  # noqa: F401
from repro_torch.runtime.hierarchy import (  # noqa: F401
    HierarchySpec,
    parse_hierarchy,
)
from repro_torch.runtime.manager import Manager, WorkItem, run_study_distributed  # noqa: F401
from repro_torch.runtime.net import (  # noqa: F401
    SocketBackend,
    run_worker,
    socket_flag_kwargs,
)
from repro_torch.runtime.objstore import (  # noqa: F401
    InMemoryObjectStore,
    LocalFSObjectStore,
    ObjectBackedStore,
    ObjectStore,
)
from repro_torch.runtime.transport import (  # noqa: F401
    Completion,
    Lease,
    ProcessRpcBackend,
    RemoteTaskError,
    ThreadBackend,
    TransportError,
    WorkerBackend,
    WorkerStatus,
    make_backend,
)
from repro_torch.runtime.simulator import (  # noqa: F401
    AutotuneResult,
    ClusterSim,
    StreamSim,
    autotune_stream,
    simulate_cluster,
    simulate_stream,
)
from repro_torch.runtime.storage import (  # noqa: F401
    HierarchicalStore,
    SharedStore,
    mount_store,
)
