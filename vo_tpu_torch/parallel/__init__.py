"""Multi-process parallelism on torch.distributed (port of
vo_tpu/parallel/): device meshes, keypoint-sharded matching and LK
tracking, row-sharded stencils with a halo exchange, landmark-sharded
Schur BA, the keypoint-sharded tracking step, a frame-parallel frontend.

Every `sharded_*` function is SPMD: each rank calls it with the mesh (and
axis name) and its own shard, and gets back its shard, or a replicated
tensor where vo_tpu's out_specs replicate.
"""

from .ba import sharded_bundle_adjust
from .frontend import batched_orb, batched_pair_match
from .matching import pad_to_multiple, sharded_match_descriptors
from .mesh import make_mesh, make_mesh_2d, replicated, shard_leading
from .tracking import sharded_lk_make_cache, sharded_lk_track
from .spatial import sharded_fast_score, sharded_gaussian_blur, sharded_stencil
from .watchdog import StepWatchdog

__all__ = [
    "sharded_bundle_adjust",
    "batched_orb",
    "batched_pair_match",
    "pad_to_multiple",
    "sharded_match_descriptors",
    "make_mesh",
    "make_mesh_2d",
    "replicated",
    "shard_leading",
    "sharded_fast_score",
    "sharded_gaussian_blur",
    "sharded_stencil",
    "StepWatchdog",
    "sharded_lk_make_cache",
    "sharded_lk_track",
]
