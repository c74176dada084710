"""Parallelism layer: the process group, the (data, model) device mesh and the sharding rules.

Counterpart of ``multimodal_timesfm_tpu/parallel/``. Batches split over the
``data`` axis (each rank its contiguous rows, gradients summed over it); the
large matmul weights optionally shard over the ``model`` axis (tensor
parallelism, the collectives written out as autograd functions). Launch one
process per device, for example
``python -m torch.distributed.run --standalone --nproc-per-node N -m multimodal_timesfm_torch.tune ...``.
"""

from multimodal_timesfm_torch.parallel.collectives import (  # noqa: F401
    ModelAxis,
    copy_to_model,
    reduce_from_model,
    scatter_to_model,
)
from multimodal_timesfm_torch.parallel.distributed import initialize_multihost  # noqa: F401
from multimodal_timesfm_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    MeshConfig,
    local_rows,
    make_mesh,
    mesh_shape,
    pad_to_multiple,
)
from multimodal_timesfm_torch.parallel.sharding import (  # noqa: F401
    gather_params,
    param_specs,
    shard_params,
    unshard_params,
)
