from video_spike_torch.core.config import (  # noqa: F401
    DictConfig,
    config_from_kwargs,
    update_config,
)
from video_spike_torch.core.rng import set_seed  # noqa: F401
