"""The asynchronous parameter-server path: the wire format and the
shared-memory rings (``networking``), the hubs, the worker clients, the
sharded plane, hub snapshots and hot standbys (``parameter_server``), the
C++ hub's binding (``native``), the seeded chaos harness (``faults``),
the five ``Async*`` trainers (``async_trainer``) and the launcher with the
``distkeras-torch-ps`` daemon (``launcher``); and the services over the
same wire: the streaming inference server (``streaming``) and the
Punchcard job daemon (``job_deployment``).  Every layer records into
``distkeras_torch.observability`` when telemetry is on."""

from distkeras_torch.runtime.async_trainer import (
    AsyncADAG,
    AsyncAEASGD,
    AsyncDistributedTrainer,
    AsyncDOWNPOUR,
    AsyncDynSGD,
    AsyncEAMSGD,
)
from distkeras_torch.runtime.faults import (
    ChaosProxy,
    Fault,
    FaultPlan,
    HubKillPlan,
    InjectedWorkerFault,
    ShardedChaosProxy,
    WorkerKillPlan,
)
from distkeras_torch.runtime.job_deployment import Job, Punchcard
from distkeras_torch.runtime.networking import (
    FlatFrameCodec,
    ProtocolError,
    configure_socket,
    connect,
    determine_host_address,
    recv_frame,
    recv_frame_into,
    recv_json,
    recv_tensors,
    send_frame,
    send_json,
    send_tensors,
)
from distkeras_torch.runtime.parameter_server import (
    ADAGParameterServer,
    DeltaParameterServer,
    DynSGDParameterServer,
    HubSnapshotter,
    InprocPSClient,
    PSClient,
    ReplicationFeed,
    ShardedParameterServer,
    ShardedPSClient,
    ShardPlan,
    SnapshotSetCoordinator,
    SocketParameterServer,
    StripeLostError,
    shard_plan,
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
    "StreamingClient", "stream_predict", "Punchcard", "Job", "ShardedParameterServer",
    "ShardedPSClient", "ShardPlan", "shard_plan", "StripeLostError", "FlatFrameCodec",
    "ProtocolError", "configure_socket", "connect", "determine_host_address", "recv_frame",
    "recv_frame_into", "recv_json", "recv_tensors", "send_frame", "send_json", "send_tensors",
    "HubSnapshotter", "ReplicationFeed", "SnapshotSetCoordinator", "ChaosProxy", "Fault",
    "FaultPlan", "HubKillPlan", "InjectedWorkerFault", "ShardedChaosProxy", "WorkerKillPlan",
]
