"""The asynchronous parameter-server path: the wire format
(``networking``), the hubs and worker clients (``parameter_server``), the
C++ hub's binding (``native``) and the five ``Async*`` trainers
(``async_trainer``); and the services over the same wire: the streaming
inference server (``streaming``) and the Punchcard job daemon
(``job_deployment``)."""

from distkeras_torch.runtime.async_trainer import (
    AsyncADAG,
    AsyncAEASGD,
    AsyncDistributedTrainer,
    AsyncDOWNPOUR,
    AsyncDynSGD,
    AsyncEAMSGD,
)
from distkeras_torch.runtime.job_deployment import Job, Punchcard
from distkeras_torch.runtime.parameter_server import (
    ADAGParameterServer,
    DeltaParameterServer,
    DynSGDParameterServer,
    InprocPSClient,
    PSClient,
    SocketParameterServer,
)
from distkeras_torch.runtime.streaming import (
    StreamingClient,
    StreamingInferenceServer,
    stream_predict,
)

__all__ = [
    "AsyncDistributedTrainer", "AsyncDOWNPOUR", "AsyncADAG", "AsyncDynSGD", "AsyncAEASGD",
    "AsyncEAMSGD", "SocketParameterServer", "DeltaParameterServer", "ADAGParameterServer",
    "DynSGDParameterServer", "PSClient", "InprocPSClient", "StreamingInferenceServer",
    "StreamingClient", "stream_predict", "Punchcard", "Job",
]
