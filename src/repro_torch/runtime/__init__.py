"""Distributed runtime: Manager-Worker demand-driven dispatch behind the
transport-agnostic WorkerBackend boundary, hierarchical storage (with the
object-store tier) and fault tolerance (heartbeats/retry/backup tasks).
This package carries the thread backend and what the Manager, the engine
and the study driver import; the socket transport and the cluster
simulator are not part of it."""

from repro_torch.runtime.fairshare import FairQueue, TaskCancelled  # noqa: F401
from repro_torch.runtime.hierarchy import (  # noqa: F401
    HierarchySpec,
    parse_hierarchy,
)
from repro_torch.runtime.manager import Manager, WorkItem, run_study_distributed  # noqa: F401
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
from repro_torch.runtime.storage import (  # noqa: F401
    HierarchicalStore,
    SharedStore,
    mount_store,
)
