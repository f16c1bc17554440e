"""The asynchronous parameter-server path: the wire format
(``networking``), the hubs and worker clients (``parameter_server``), the
C++ hub's binding (``native``) and the five ``Async*`` trainers
(``async_trainer``)."""

from distkeras_torch.runtime.async_trainer import (
    AsyncADAG,
    AsyncAEASGD,
    AsyncDistributedTrainer,
    AsyncDOWNPOUR,
    AsyncDynSGD,
    AsyncEAMSGD,
)
from distkeras_torch.runtime.parameter_server import (
    ADAGParameterServer,
    DeltaParameterServer,
    DynSGDParameterServer,
    InprocPSClient,
    PSClient,
    SocketParameterServer,
)

__all__ = [
    "AsyncDistributedTrainer", "AsyncDOWNPOUR", "AsyncADAG", "AsyncDynSGD", "AsyncAEASGD",
    "AsyncEAMSGD", "SocketParameterServer", "DeltaParameterServer", "ADAGParameterServer",
    "DynSGDParameterServer", "PSClient", "InprocPSClient",
]
