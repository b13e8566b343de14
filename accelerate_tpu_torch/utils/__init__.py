from .convert import flax_from_state_dict, state_dict_from_flax
from .device import resolve_device
