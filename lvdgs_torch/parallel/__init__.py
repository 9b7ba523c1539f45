"""Multi-device paths on torch.distributed: meshes, the collectives, the
rank launcher and the sharded mapping step (port of ``lvdgs_tpu/parallel``).
Tile-sharded tracking is ``slam.tracking.track_camera_sharded``; camera-
data-parallel mapping is ``slam.mapping.mapping_run(..., mesh=...)``."""
from .dp_mapping import make_sharded_mapping_step
from .mesh import make_mesh
