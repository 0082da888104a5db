from vkrt_jax.golden.cpu_tracer import render_golden

__all__ = ["render_golden"]
