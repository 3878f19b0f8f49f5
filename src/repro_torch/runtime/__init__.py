"""The training runtime (``repro.runtime``): the fault-tolerant
`TrainLoop`, straggler detection, int8 gradient compression with error
feedback, and elastic resharding onto a `repro_torch.mesh.Mesh`."""
from repro_torch.runtime.loop import TrainLoop, LoopConfig, StepResult
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.runtime.compression import (
    compress_int8, decompress_int8, compressed_allreduce_spec,
    ErrorFeedbackState, init_error_feedback, compress_with_feedback,
)
from repro_torch.runtime.elastic import reshard_tree, ElasticPlan, gather_tree

__all__ = [
    "TrainLoop", "LoopConfig", "StepResult",
    "StragglerMonitor",
    "compress_int8", "decompress_int8", "compressed_allreduce_spec",
    "ErrorFeedbackState", "init_error_feedback", "compress_with_feedback",
    "reshard_tree", "ElasticPlan", "gather_tree",
]
