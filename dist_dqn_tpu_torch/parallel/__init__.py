"""Data-parallel training over a process group (twin of
dist_dqn_tpu/parallel/): the mesh, the mesh trainers and the process-group
runtime (parallel/distributed.py)."""
from dist_dqn_tpu_torch.parallel.mesh import Mesh, make_mesh  # noqa: F401
from dist_dqn_tpu_torch.parallel.learner import (  # noqa: F401
    make_mesh_fused_train, make_mesh_r2d2_train)
