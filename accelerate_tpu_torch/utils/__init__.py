from .convert import flax_from_state_dict, state_dict_from_flax
from .dataclasses import (
    AutocastKwargs,
    DataLoaderConfiguration,
    GradientAccumulationPlugin,
    ProfileKwargs,
    ProjectConfiguration,
)
from .device import resolve_device
from .memory import (
    clear_device_cache,
    find_executable_batch_size,
    get_device_memory_stats,
    release_memory,
)
from .random import set_seed
