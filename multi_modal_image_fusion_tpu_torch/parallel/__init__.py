"""Parallelism of the port: data parallelism over torch.distributed
(mesh.py), height sharding's eligibility and halo (spatial.py) and
single-card height tiling (tiling.py, imported from there: it imports the
ops that import mesh.py)."""

from .mesh import (all_reduce_mean, broadcast_module, global_sum,
                   init_multihost, is_main_process, shard_batch, world_size)
from .spatial import (SPATIAL_ELIGIBLE, check_spatial_eligible,
                      receptive_halo)
