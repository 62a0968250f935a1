from .layout import canonicalize, maybe_scalar, restore_param_shape
from .split import split_chains_reshape

__all__ = ["canonicalize", "maybe_scalar", "restore_param_shape",
           "split_chains_reshape"]
