from vkrt_jax.rt.traverse import trace_closest, trace_occluded

__all__ = ["trace_closest", "trace_occluded"]
