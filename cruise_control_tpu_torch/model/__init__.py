from cruise_control_tpu_torch.model.builder import ClusterModelBuilder, split_leader_follower
from cruise_control_tpu_torch.model.cluster_tensor import (
    ClusterMeta, ClusterTensor, bucket_size, pad_cluster,
)
from cruise_control_tpu_torch.model.random_cluster import (
    RandomClusterSpec, generate, generate_scale,
)

__all__ = [
    "ClusterModelBuilder", "ClusterMeta", "ClusterTensor", "RandomClusterSpec",
    "bucket_size", "generate", "generate_scale", "pad_cluster",
    "split_leader_follower",
]
