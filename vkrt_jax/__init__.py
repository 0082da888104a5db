"""vkrt_jax — a wavefront ray-tracing framework in JAX.

A ground-up JAX/XLA re-design of the capabilities of jparimaa/vkrt: a
seeded Sponza-shaped scene (or glTF scene loading), on-device LBVH
acceleration-structure construction, stackless BVH traversal + ray-triangle
intersection, vectorized hit shading (4 point lights, hard shadows, metallic
reflections), and a wavefront frame engine over lane-major ray blocks —
replacing the Vulkan VK_KHR_ray_tracing pipeline, driver-built BLAS/TLAS,
and shader-binding-table dispatch of the reference.

Layers (bottom-up), mirroring SURVEY.md §7:
  scene/     generated scene, glTF ingest     (ref: src/Model.{hpp,cpp})
  accel/     LBVH build (Morton + radix sort) (ref: driver BLAS/TLAS,
                                               src/Raytracer.cpp:1027-1283)
  rt/        batched traversal + intersection (ref: vkCmdTraceRaysKHR)
  shade/     hit shading + texture sampling   (ref: shaders/shader.rchit)
  wavefront/ frame engine, ray queues         (ref: shaders/shader.rgen + SBT)
  parallel/  multi-GPU sharding over rays     (ref: none — new capability)
  app/       camera, config, CLI, harness     (ref: src/Camera.cpp, main.cpp)
"""

from vkrt_jax.version import __version__

__all__ = ["__version__"]
