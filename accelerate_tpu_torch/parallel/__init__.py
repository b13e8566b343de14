from .sharding import RematPolicy, resolve_remat_policy
