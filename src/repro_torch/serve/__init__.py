"""Serving (port of ``repro.serve``): the batched engine, and the weight-delta
ring with its publisher and subscriber."""

from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.publish import PublishConfig, SpectrumReplicaState, WeightDeltaPublisher
from repro_torch.serve.ring import RingReader, RingWriter
from repro_torch.serve.subscribe import ReplicaSubscriber, SyncStats

__all__ = [
    "ServeConfig",
    "Engine",
    "PublishConfig",
    "SpectrumReplicaState",
    "WeightDeltaPublisher",
    "RingReader",
    "RingWriter",
    "ReplicaSubscriber",
    "SyncStats",
]
