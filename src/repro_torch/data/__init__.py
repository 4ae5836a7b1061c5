"""Host-side data plane.

The training input pipeline is a publish/subscribe dataflow — exactly the
topology the paper targets: fault-isolated stages exchanging *unsized*
messages (documents and token batches are ragged). Stages communicate over
the agnocast zero-copy plane (`repro_torch.core`), with the serialized bus as the
conventional fallback, so the paper's selective-adoption property holds for
the ML data plane too.

* :mod:`repro_torch.data.synthetic` — deterministic, seeded document stream
  (variable-length = unsized payloads), shardable per host.
* :mod:`repro_torch.data.packing` — pack ragged documents into dense (B, S)
  training batches (the "concatenate node" of the ML pipeline).
* :mod:`repro_torch.data.pipeline` — the staged pipeline: in-process for tests,
  multi-process over agnocast topics for the real thing.

The port's copy of ``repro/data/__init__.py``: only the import paths
differ, so the two packages give the same documents and batches from the same seed.
"""

from .packing import pack_documents, unpack_batch
from .pipeline import (
    BatchSpec,
    InProcessPipeline,
    PipelineStageStats,
    ZeroCopyFeeder,
    ZeroCopyPipeline,
)
from .synthetic import SyntheticCorpus

__all__ = [
    "SyntheticCorpus",
    "pack_documents",
    "unpack_batch",
    "BatchSpec",
    "InProcessPipeline",
    "ZeroCopyPipeline",
    "ZeroCopyFeeder",
    "PipelineStageStats",
]
