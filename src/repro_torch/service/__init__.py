"""SA-as-a-service: a long-lived multi-tenant study server (DESIGN.md
§18) over one persistent Manager/SharedStore pool.

``StudyServer`` owns the pool and the job registry; tenants submit
serializable :class:`StudySpec` jobs — in process via the server object,
or over TCP via :class:`ServiceClient` against ``python -m repro_torch.service``.
"""

from repro_torch.service.client import ServiceClient, ServiceError  # noqa: F401
from repro_torch.service.registry import (  # noqa: F401
    JOB_STATES,
    JobRecord,
    JobRegistry,
    QuotaExceeded,
    TenantQuota,
)
from repro_torch.service.server import StudyServer  # noqa: F401
from repro_torch.service.spec import SpecError, StudySpec  # noqa: F401

__all__ = [
    "JOB_STATES",
    "JobRecord",
    "JobRegistry",
    "QuotaExceeded",
    "ServiceClient",
    "ServiceError",
    "SpecError",
    "StudyServer",
    "StudySpec",
    "TenantQuota",
]
