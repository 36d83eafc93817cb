"""Cross-view association on tensors: the ray-distance affinity and the
batched SVT matching of step 2, and the pictorial-structure inference with
its transitive closure (port of ``macaque_tpu/association``)."""

from macaque_tpu_torch.association.affinity import (
    build_rays,
    line_distance_matrix,
    geometry_affinity,
    combined_affinity,
)
from macaque_tpu_torch.association.svt import (
    match_svt, proj_2dpam, project_simplex)
from macaque_tpu_torch.association.pictorial import (
    macaque_skeleton_tree,
    infer_pictorial_3d,
    transitive_closure,
)

__all__ = [
    "build_rays",
    "line_distance_matrix",
    "geometry_affinity",
    "combined_affinity",
    "match_svt",
    "proj_2dpam",
    "project_simplex",
    "macaque_skeleton_tree",
    "infer_pictorial_3d",
    "transitive_closure",
]
