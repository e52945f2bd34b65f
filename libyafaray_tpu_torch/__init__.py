"""libyafaray_tpu_torch — the PyTorch + CUDA port of libyafaray_tpu.

The JAX package `libyafaray_tpu` is the reference; this package mirrors its
tree and names so each module has an obvious counterpart, and is held
against it by the `tests/test_torch_*.py` parity tests.  It imports torch
and never jax, and nothing from `libyafaray_tpu`.

Slice 1 covers the Cornell pathtracing main path: XML parse -> scene
compile -> `integrators/render.py` `render_timed` -> wavefront sample step
-> film -> image.  Its two intersection kernels are hand-written CUDA for
Hopper (`csrc/tiny_intersect.cu`, bound in `ops/cuda_intersect.py`).  Every
feature outside the slice raises NotImplementedError naming its ROADMAP
item.

  core/         math, color, QMC, sampling warps
  scene/        params, meshes, XML parser, scene compile, session
  cameras/      perspective shoot_rays
  materials/    material table, shinydiffuse / light / null BSDFs
  lights/       light table, area-light sampling
  backgrounds/  constant background
  ops/          intersection dispatch + CUDA kernels and plain versions
  film/         box filter, scatter-free splat, film image
  integrators/  the wavefront engine (path mode) and the render loop
  io/           EXR reading for the golden comparison
  convert.py    reference compiled scene -> port tensors
"""

__version__ = "0.1.0"
