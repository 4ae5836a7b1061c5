"""Application-level stage library (the Autoware-analogue workloads), the
port's copy of ``repro.apps`` over ``repro_torch.core``."""

from .pointcloud import (
    ChainResult,
    LidarSpec,
    make_cloud,
    preprocess_chain,
    run_chain,
)

__all__ = ["LidarSpec", "ChainResult", "make_cloud", "preprocess_chain",
           "run_chain"]
