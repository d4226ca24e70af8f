from audio_rag_tpu_torch.jobqueue.job import (
    IngestJob,
    JobCheckpoint,
    JobResult,
    JobStage,
    JobStatus,
    Priority,
)
from audio_rag_tpu_torch.jobqueue.queue import AudioRAGQueue

__all__ = [
    "AudioRAGQueue",
    "IngestJob",
    "JobResult",
    "JobCheckpoint",
    "JobStatus",
    "JobStage",
    "Priority",
]
