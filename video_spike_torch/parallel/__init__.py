from video_spike_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    make_mesh,
    pad_batch_to_multiple,
    replicated,
)
