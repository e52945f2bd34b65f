"""libyafaray_tpu_torch — the PyTorch + CUDA port of libyafaray_tpu.

The JAX package `libyafaray_tpu` is the reference; this package mirrors its
tree and names so each module has an obvious counterpart, and is held
against it by the `tests/test_torch_*.py` parity tests.  It imports torch
and never jax, and nothing from `libyafaray_tpu`.

The entry points are `scene/session.py` `render_scene`, the flat API
`scene/interface.py` `Interface` and the CLI `python -m
libyafaray_tpu_torch scene.xml out.exr` (= `-m
libyafaray_tpu_torch.cli.yafaray_xml`): XML
parse -> scene compile -> `integrators/render.py` (pathtracing,
directlighting, with the volume integrator), `integrators/photonmap.py`
(photon mapping), `integrators/sppm.py` (SPPM), `integrators/veach.py`
(bidirectional) or `integrators/debug.py` -> wavefront sample step or pass -> film ->
image.  They run on the card ("cuda") unless the caller passes
device="cpu".  Every Pallas kernel of the reference on these paths, and
its threaded-BVH walks (the intersector of scenes above 2^20 triangles),
is hand-written CUDA for Hopper under `csrc/`, with a plain PyTorch
version beside its wrapper in `ops/`.  Several devices render one film as
ranks of a torch.distributed group, one process a device (`parallel/`):
`render_scene(n_devices=N)`, the CLI's `--devices N`, or torchrun.

  core/         math, color, QMC, sampling warps
  scene/        params, meshes, XML parser and writer, scene compile,
                session, the flat Interface, the grid-spheres scene
                generator
  accel/        the threaded BVH's builder (numpy, and C++ built with g++)
  cameras/      shoot_rays of every camera type (thin-lens depth of
                field, bokeh), pixel cone, projection
  materials/    material table, the ported BSDFs, blend and mask
  lights/       light table, area-light sampling, the IBL light (alias
                table over the environment map)
  backgrounds/  constant, gradient and texture backgrounds, the sunsky /
                darksky bakes (Preetham, Hosek-Wilkie), the env-map blur
  volumes/      volume regions, the emission and single-scatter marches
  textures/     image textures (mip atlas, nearest / bilinear / bicubic /
                trilinear / EWA), procedural textures, node programs
  ops/          intersection dispatch (clustered kernels, BVH walks),
                photon gathers: CUDA wrappers and plain versions
  film/         filters, scatter-free splat, film image, density, alpha
                and render-pass planes, film save / load, the NLM
                denoise
  integrators/  the wavefront engine (path and direct modes), photon
                mapping and the path tracer's caustic map, SPPM, the
                render loops
  parallel/     the process group, the film mesh (row bands a rank), the
                summed film and the photon gather
  io/           EXR (multilayer, scanline or tiled; NONE, ZIPS, PXR24,
                B44, B44A, PIZ written, RLE and ZIP read too), RGBE, PNG
                and 8-bit image output; PNG read without Pillow
  utils/        render logs and the parameter badge
  cli/          the yafaray-xml command line, the RMSE compare tool
  convert.py    reference compiled scene -> port tensors
"""

__version__ = "0.1.0"
