from cruise_control_tpu_torch.model.builder import ClusterModelBuilder, split_leader_follower
from cruise_control_tpu_torch.model.cluster_tensor import (
    ClusterMeta, ClusterTensor, bucket_size, pad_cluster,
)
from cruise_control_tpu_torch.model.random_cluster import (
    RandomClusterSpec, generate, generate_scale,
)
from cruise_control_tpu_torch.model.sanity import SanityCheckError, sanity_check
from cruise_control_tpu_torch.model.stats import ClusterStats, cluster_stats

__all__ = [
    "ClusterModelBuilder", "ClusterMeta", "ClusterStats", "ClusterTensor",
    "RandomClusterSpec", "SanityCheckError", "bucket_size", "cluster_stats",
    "generate", "generate_scale", "pad_cluster", "sanity_check",
    "split_leader_follower",
]
