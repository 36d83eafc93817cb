"""Cross-view association on tensors: the ray-distance affinity and the
batched SVT matching of step 2 (port of ``macaque_tpu/association``; its
pictorial-structure module is not ported yet)."""

from macaque_tpu_torch.association.affinity import (
    build_rays,
    line_distance_matrix,
    geometry_affinity,
    combined_affinity,
)
from macaque_tpu_torch.association.svt import (
    match_svt, proj_2dpam, project_simplex)

__all__ = [
    "build_rays",
    "line_distance_matrix",
    "geometry_affinity",
    "combined_affinity",
    "match_svt",
    "proj_2dpam",
    "project_simplex",
]
