from vkrt_jax.utils.log import get_logger, check
from vkrt_jax.utils import mathutils

__all__ = ["get_logger", "check", "mathutils"]
