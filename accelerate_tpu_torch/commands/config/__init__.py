from .config import config_command_parser  # noqa: F401
from .config_args import ClusterConfig, default_config_file, load_config_from_file  # noqa: F401
from .default import write_basic_config  # noqa: F401
