"""Multi-process runs: the ``(data, model)`` mesh over ``torch.distributed``
(``mesh.py``), process-group start-up (``distributed.py``), the mesh's
collectives (``collectives.py``) and the sharded zero-shot eval
(``eval_spmd.py``); the SPMD train step is ``train/spmd.py``."""

from .distributed import host_local_batch_slice, init_distributed
from .mesh import Mesh, make_mesh

__all__ = ["Mesh", "make_mesh", "host_local_batch_slice", "init_distributed"]
