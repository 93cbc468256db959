"""Multi-device MSM on torch.distributed: one process a device, a mesh over
the world (`make_mesh`, `make_mesh_2d`), the point-sharded MSM engines
(`msm_sharded`, `msm_sharded_ladder`, `msm_sharded_stream`), and
`distributed` to join the world. Counterpart of the JAX package's
`parallel`."""
from curdleproofs_tpu_torch.parallel import distributed
from curdleproofs_tpu_torch.parallel.mesh import Mesh, make_mesh, make_mesh_2d
from curdleproofs_tpu_torch.parallel.msm import msm_sharded, msm_sharded_ladder, msm_sharded_stream

__all__ = [
    "Mesh",
    "distributed",
    "make_mesh",
    "make_mesh_2d",
    "msm_sharded",
    "msm_sharded_ladder",
    "msm_sharded_stream",
]
