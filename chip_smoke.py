"""On-card smoke run of the PyTorch + CUDA port (libyafaray_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from csrc/ (one nvcc per source, all
started together) and drives the ported paths through them:
- slice 1, the Cornell pathtracing main path (bench.py config 1): the two
  tiny-scene kernels against their plain PyTorch versions at the path's
  shapes, the 512²·64 spp render, one profiled sample step, the physics
  against the stored golden and the card against the CPU;
- slice 2, the generated 164K-triangle grid-spheres scene (bench.py config
  3, written here by the port's generator, scene/generate.py): the two
  large-scene kernels against their plain versions at the path's shapes,
  the 512²·4 spp render, one profiled sample step, and the card against the
  CPU on a small generated grid;
- slice 3, photon mapping on scenes/cornell_photon.xml (BASELINE config 3,
  glass and glossy analytic spheres): the three photon-gather kernels
  against their plain versions at the path's shapes (the nearest lookup's
  culled search also against the brute-force kernel on every query), the
  full-width render
  (512², 16 spp, 200,000 + 100,000 photons, final gather 16) through the
  entry point `render_scene`, one profiled sample step, cornell.xml against
  the stored photon-mapping golden, the card against the CPU, and the
  2,000,000-photon scale route, where the diffuse map takes the culled
  layout and its kernel;
- slice 4, the generated mid-size scenes at their own settings (512²,
  16 spp): 172 triangles in 2 clusters (the dense kernels) and 652 in 6
  (the streaming kernels), each kernel against its plain version on rays
  recorded from a real sample step, the render through the entry point
  `render_scene`, the same scene through the port's CLI to an .exr, one
  profiled step, and the card against the CPU;
- slice 5, the pair-granular route (`Scene.compile(pairs=True)`): its two
  kernels against their plain versions on slots recorded from a real grid
  step, the fine kernels on the grid's recorded bounce-1 rays (the closest
  hit against its plain version where the walk order matters, the
  one-sample shadow launch with its bound), the pair route against the
  fine route on the grid's recorded
  bounce-1 and NEE rays, the 164K grid at 512², 4 spp through
  `render_scene(pairs=True)` against slice 2's fine-route render, one
  profiled step split by stage, the card against the CPU on the
  10,252-triangle grid, the 131,072-triangle random soup with 262,144
  incoherent and coherent rays on both routes against the brute force, and
  the fine closest hit on a 300,000-triangle soup (more cluster boxes than
  one sweep of its walk holds) against the brute force;
- slice 7, the two shadow-sum kernels rebuilt around one shared-memory tile
  routine (csrc/shadow_tile.cuh): inside the phases above,
  `shadow_logsum_fine` is held to its plain version on the grid's bounce-0
  batch and on its bounce-1 launch (rays from scattered bounce points),
  `pairs_shadow` takes the sub-box table, and on the soup, whose filters are
  not binary, each of the two is called twice and must repeat bit for bit;
- slice 8, `pairs_closest` on the same tile routine (a (t, column) minimum,
  sub-boxes skipped beyond a slot's best hit) and `density_flash` over
  Morton-sorted packs (one warp a query, the clusters within its radius):
  inside the phases above each is held to its plain version, called twice
  and compared bit for bit, and timed beside the body it replaced on the
  same inputs (`ms_before`: the one-thread pair body; the brute force over
  the same photons in their original order), with its registers;
- slice 10, `shadow_logsum_dense` (two rays a thread over the staged pack)
  and `closest_hit_stream` (a warp a ray), both skipping by the pack's
  32-column quarter boxes: inside slice 4's phases each must equal its
  plain version bit for bit and repeat bit for bit, is timed beside the
  one-thread body it replaced on the same rays (`ms_before`) and held
  equal to it on every batch its scene's step records (`[old_body]`), with
  its registers and the pair tests its walk makes; its bound counts the
  pairs of the quarter boxes, the old body's bound (`bound_ms_before`) those
  of the cluster boxes;
- slice 11, `shadow_logsum_stream` and `shadow_logsum_tiny` on the column
  walk that `shadow_logsum_dense` takes (csrc/column_walk.cuh): the stream
  sum over the quarter boxes, each ray until all three of its channels are
  opaque; the tiny sum over 2-column boxes its kernel builds per block.
  Each is held to its plain version and to the body it replaced, repeats
  bit for bit, and is timed beside that body on its bounce-0 and bounce-1
  launches, as slice 10's kernels are;
- slice 12, `closest_hit_tiny` and `closest_hit_dense` on the closest walk
  of csrc/column_walk.cuh over boxes of 2 and 16 columns their kernels
  build per block (a ray's nearest box by its own thread, its other boxes
  as items the block's threads share): each is held to its plain version
  bit for bit (t, tri, u, v; t, column) and to the body it replaced on
  every call of one step of its scene, repeats bit for bit, and is timed
  beside that body on its primary and bounce-1 calls;
- slice 14, the three scenes the port renders now at their own settings,
  each through the entry point `render_scene`: scenes/cornell.xml
  (directlighting, raydepth 3, 512², 64 spp; also through the CLI, one
  profiled step, the card against the CPU at 64², 4 spp);
  scenes/cornell_path.xml (pathtracing with a Beer glass sphere, bench.py
  config 2's 512², 16 spp: the tiny kernels against their plain versions
  on this path's recorded rays, one profiled step, the card against the
  CPU), the same with caustic_type=both at 4 spp (the caustic map's
  gather against density_flash_plain and the brute force); and
  scenes/cornell_sppm.xml (SPPM, 512², 16 passes, 200,000 photons: the
  first and last passes' gathers with per-hit-point radii against
  density_flash_plain, one profiled pass, the card against the CPU at 32²,
  2 passes, 16,384 photons, and cornell.xml with the golden's SPPM
  overrides against scenes/goldens/cornell_SPPM.exr);
- slice 15, scenes/ibl_spheres.xml (BASELINE config 5: a textureback
  env.hdr with its importance-sampled IBL light, 8 samples, a mipmapped
  checker.png floor, glass and glossy spheres; pathtracing, bounces 5,
  512², 64 spp) through `render_scene` and the CLI: its two assets loaded
  from their files (not the reference's stand-ins), the tiny kernels
  against their plain versions on the IBL step's recorded primary rays and
  bounce-0 NEE rays (8 samples a pixel, segments of 1e8 toward the
  environment), one profiled step, the card against the CPU at 64², 4 spp,
  and 96², 48 spp against scenes/goldens/ibl_spheres.exr;
- slice 16, adaptive AA on the main path: scenes/cornell.xml as
  pathtracing at 512² with AA_passes 4 on the scene's own AA settings
  (64 spp, then 16 a pass over the pixels the contrast estimator flags)
  through `render_scene`, a line per pass (flagged pixels, lanes, compact
  or dense, steps, wall), the same render with compact=False (films and
  rays equal), the tiny kernels against their plain versions on a compact
  pass's rays (dead lanes included), one dense and one compact step
  profiled, 96² against the stored golden and the card against the CPU at
  64²; then the time-to-RMSE protocol's step (128², 64 samples a pixel in
  one step of 1,048,576 lanes), the tiny kernels on its primary rays and
  its 16,777,216 bounce-0 NEE rays, and the main path timed at spp_batch
  1, 4 and 16;
- slice 17, bidirectional path tracing on scenes/cornell_bidir.xml at its
  own settings (raydepth 3, 512², 64 spp, a Beer glass and a glossy
  chrome sphere, one area light) through `render_scene(timed=True)`, each
  tiny kernel launched as often a step as the BDPT step's loops ask (5
  closest hits, 8 shadow batches), every call of one step held to its
  plain version, one profiled step, 96², 48 spp against
  scenes/goldens/cornell_bidir.exr, the card against the CPU at 32², 4
  spp (the t=1 density plane on its own, and the card against itself:
  that plane adds through atomics), the CLI at 64²; and the
  DebugIntegrator's normals of cornell.xml at 512² (one closest hit)
  against the CPU;
- slice 18, every light type on scenes/cornell_lights.xml (352 triangles,
  the dense kernels) at its own settings, as BDPT and as photon mapping;
- slice 19, scenes/sky_fog.xml at its own settings (pathtracing, bounces
  3, 512², 16 spp: a sunsky with its IBL light and a sun, an exponential
  ground fog under the single-scatter volume integrator, a thin-lens
  camera with hexagonal bokeh; 26 camera-visible triangles on the tiny
  closest hit, 334 shadow casters on the dense shadow sum) through
  `render_scene(timed=True)` and the CLI, each kernel launched as often a
  step as the engine's and the march's loops ask, both held to their
  plain versions on the step's primary rays and a fog in-scatter batch,
  one profiled step with the volume layer's launches, the card against
  the CPU at 32², 2 spp under every camera type, darksky, BDPT with the
  architect camera, photon mapping with depth of field and a gradient
  background's IBL with an emission fog, `optimize` against the exact
  march, and the four object-visibility variants at 64²;
- slice 20, the film layer on scenes/ibl_passes.xml (ibl_spheres.xml's
  scene with all 28 render passes, bg_transp and bg_transp_refract) at its
  own settings (512², 64 spp, bounces 5) through `render_scene`: the tiny
  kernels launched as the loops ask (one more shadow batch a step for the
  AO pass), every plane finite and the reference's pass and alpha
  semantics; one step profiled with the planes on and off (the film
  layer's added launches, at most 2,000); every plane and alpha card
  against CPU at 32², 4 spp on ibl_passes.xml and cornell.xml, at
  spp_batch 4, over compact adaptive passes (bit-equal to dense ones) and
  BDPT's first-hit planes; film save / load resumed to the straight film
  under the path tracer, photon mapping, SPPM and BDPT, and a time
  autosave; the CLI's multilayer .exr, -z and --film; and the NLM denoise
  of the 512² image, card against CPU;
- slice 21, scenes/cornell_surfaces.xml (a cylinder under <smooth>, two
  <instance>s of it, one mirrored, a rough-glass ball and a dispersive
  prism; 166 triangles) at its own settings (pathtracing, bounces 5,
  512², 16 spp) through `render_scene(timed=True)` and the CLI (64²): the
  dense kernels launched as the loops ask and held to their plain
  versions on the step's primary rays and the prism lamp's NEE batch, one
  profiled step, the card against the CPU at 32², 4 spp under four
  integrators, the reference's rough-glass white furnace and its
  dispersion sampler's assertions on the card;
- slice 22, scenes above 2^20 triangles: the generated 2,621,452-triangle
  grid compiled onto the threaded BVH (the native builder asserted), the
  two BVH kernels (csrc/bvh_walk.cu) bit-equal to their plain lockstep
  walks and to the bodies they replaced on a step's recorded primary,
  bounce-1 and NEE rays, their bound from their own counting walk, the
  path at the scene's settings (512², 4 spp) through `render_scene(timed=True)`, one profiled step and the
  card against the CPU at 16²; the BVH against the fine kernels on the
  164K grid under the intersection contract; `env.hdr` rewritten by the
  port's EXR writer as NONE, ZIPS, PIZ and tiled ZIPS under
  `ibl_spheres.xml` (bit-equal films); `cornell.xml` built through the
  flat `Interface` (bit-equal to the XML route), and `python -m
  libyafaray_tpu_torch` checked by `python -m
  libyafaray_tpu_torch.cli.compare` at RMSE 0.
- slice 24, several devices: two ranks of one gloo process group share
  the card (its machine has one) and render, inside the group through
  `render_scene`, the main path at full width (cornell.xml as
  pathtracing, 512², 64 spp, bounces 4) and, at 128², cornell_photon.xml,
  cornell_sppm.xml (4 passes), cornell_bidir.xml (4 spp) and adaptive AA
  (4 passes); each is held to the one-device render of the same call
  (image within 1e-5, photon mapping, SPPM and BDPT 1e-4, BDPT's density
  RMSE 1e-5, rays within 1, at 512² within 1e-6 relative), the ranks'
  lanes and rays summing to the one-device counts; the photon packs
  built over the mesh bit-equal to one device's; and the CLI under two
  env-initialised ranks (torchrun's variables) at 64².  Both ranks share
  one card, so nothing here measures scaling;
- slice 25, the pair route's entries as a kernel (csrc/pair_entries.cu,
  `nearest_clusters`: each ray's k nearest cluster entries, ids and count
  without the rays x boxes table): inside slice 5's phases it is held to
  its plain version bit for bit on the grid step's recorded 262,144
  primary rays (k 21) and 2,097,152 bounce-0 NEE segments (k 24), with the
  NEE call's peak device memory, and on the 300,000-triangle soup's
  cluster boxes (k 21 and 24); `[pairs_path]` counts its 8 launches a step
  and sets the pair step's wall, busy ms and launches beside the fine
  route's.
A profile phase reads the trace from the profiler's raw events
(`trace_events`: torch's own event tree, kernel links and merges,
without building its event objects).  The untimed checks (every card
against CPU phase and the goldens) run after the timed phases, in one
block whose CPU renders go to a pool of processes (`run_deferred`).
`python3 chip_smoke.py --only slice17` (or slice18 to slice22, slice24,
slice25)
builds the kernels and runs that slice's phases alone (an iteration run:
no result line).  Each path is
rendered with every launch counter set to 0 just before it and read just
after.  Every kernel's line carries its bound: the larger of its
FP32 operations over the card's 67 TFLOP/s and its bytes (each input read
once, each output written once) over 3.35 TB/s, with the pair tests counted
from this run's rays.  Every phase prints one line; any failure raises and
the script exits non-zero without printing a result.  The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports nothing of JAX and runs no program of the repository but the
port's own command line and compare tool (`python -m
libyafaray_tpu_torch`, `-m libyafaray_tpu_torch.cli.compare`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from libyafaray_tpu_torch.cli.yafaray_xml import main as cli_main  # noqa: E402
from libyafaray_tpu_torch.convert import to_tensors  # noqa: E402
from libyafaray_tpu_torch.core import qmc  # noqa: E402
from libyafaray_tpu_torch.integrators import engine  # noqa: E402
from libyafaray_tpu_torch.integrators.config import RenderConfig  # noqa: E402
from libyafaray_tpu_torch.integrators.render import (  # noqa: E402
    _fresh_film, render, render_timed)
from libyafaray_tpu_torch.io.exr import read_exr  # noqa: E402
from libyafaray_tpu_torch.accel import bvh as bvh_mod  # noqa: E402
from libyafaray_tpu_torch.ops import _build  # noqa: E402
from libyafaray_tpu_torch.ops import bvh_traverse as bt  # noqa: E402
from libyafaray_tpu_torch.ops import cluster_intersect as cx  # noqa: E402
from libyafaray_tpu_torch.ops import cuda_intersect as ci  # noqa: E402
from libyafaray_tpu_torch.ops import fine_intersect as fi  # noqa: E402
from libyafaray_tpu_torch.ops import intersect as isect  # noqa: E402
from libyafaray_tpu_torch.ops import pairs_intersect as pi  # noqa: E402
from libyafaray_tpu_torch.ops import photon_flash as pf  # noqa: E402
from libyafaray_tpu_torch.film.passes import (  # noqa: E402
    PASS_NAMES, film_add_passes)
from libyafaray_tpu_torch.integrators import photonmap  # noqa: E402
from libyafaray_tpu_torch.integrators import render as rmod  # noqa: E402
from libyafaray_tpu_torch.integrators import sppm  # noqa: E402
from libyafaray_tpu_torch.integrators import veach  # noqa: E402
from libyafaray_tpu_torch.scene.generate import (  # noqa: E402
    make_rays, make_soup, write_grid_spheres)
from libyafaray_tpu_torch.scene.session import (  # noqa: E402
    build_config, render_scene)
from libyafaray_tpu_torch.scene.xml_parser import parse_xml_file  # noqa: E402
from libyafaray_tpu_torch.lights import base as lightmod  # noqa: E402
from libyafaray_tpu_torch.lights.ies import parse_ies  # noqa: E402
from libyafaray_tpu_torch.scene.params import ParamMap  # noqa: E402
from libyafaray_tpu_torch.scene import scene as scene_mod  # noqa: E402
from libyafaray_tpu_torch.scene.scene import Scene  # noqa: E402

CORNELL = os.path.join(REPO, "scenes", "cornell.xml")
GOLDEN = os.path.join(REPO, "scenes", "goldens", "cornell_pathtracing.exr")
PHOTON = os.path.join(REPO, "scenes", "cornell_photon.xml")
CORNELL_PATH = os.path.join(REPO, "scenes", "cornell_path.xml")
CORNELL_SPPM = os.path.join(REPO, "scenes", "cornell_sppm.xml")
SPPM_GOLDEN = os.path.join(REPO, "scenes", "goldens", "cornell_SPPM.exr")
IBL = os.path.join(REPO, "scenes", "ibl_spheres.xml")
IBL_GOLDEN = os.path.join(REPO, "scenes", "goldens", "ibl_spheres.exr")
BIDIR = os.path.join(REPO, "scenes", "cornell_bidir.xml")
BIDIR_GOLDEN = os.path.join(REPO, "scenes", "goldens", "cornell_bidir.exr")
PHOTON_GOLDEN = os.path.join(REPO, "scenes", "goldens",
                             "cornell_photonmapping.exr")
SOURCES = _build.CUDA_SOURCES
SRC = "libyafaray_tpu_torch/csrc/{}.cu"
PALLAS = "libyafaray_tpu/ops/pallas_intersect.py:{}"
FLASH = "libyafaray_tpu/ops/photon_flash.py:{}"
# main path: bench.py config 1
MAIN = dict(size=512, spp=64, bounces=4, rr_min_bounces=2)
# slice 2: bench.py config 3 (the scene's own pathtracing settings)
GRID = dict(grid=4, subdiv=4, size=512, spp=4)
# rays the grid kernels' plain brute force is compared and timed on (it
# runs ~40 ns a ray-triangle pair): every 4th primary ray, every 32nd of the
# bounce-0 NEE block (light samples x pixels)
PLAIN_GRID_STRIDE = dict(closest=4, shadow=32)
# slice 3 runs cornell_photon.xml at its own settings (BASELINE config 3);
# the golden is cornell.xml with the overrides it was rendered with
GOLDEN_PHOTON = dict(integrator="photonmapping", photons=200_000,
                     caustic_photons=50_000, fg_samples=24, raydepth=4,
                     aa_samples=24, aa_passes=1)
CARD_VS_CPU_PHOTON = dict(size=32, aa_samples=2, photons=16_384,
                          caustic_photons=8_192, fg_samples=4)
# the scale route: diffuse stores above CULL_MIN_PHOTONS
SCALE = dict(size=128, aa_samples=1, photons=2_000_000)
# slice 14: cornell_path.xml at bench.py config 2's 16 spp, its caustic map
# at 4 spp; the card against the CPU at 64², 4 spp (SPPM: 32², 2 passes,
# 16,384 photons); the SPPM golden's overrides (as the golden was made)
GLASS_SPP, CAUSTIC_SPP = 16, 4
CARD_VS_CPU_SPPM = dict(size=32, sppm_passes=2, sppm_photons=16_384)
GOLDEN_SPPM = dict(integrator="SPPM", sppm_photons=100_000, sppm_passes=48,
                   raydepth=4)
# slice 15: ibl_spheres.xml's assets as its textures must hold them (a
# failed load leaves a 16 x 16 stand-in), and the golden's sample count
# (tests/test_golden.py's: RMSE < 0.05 against the 192 spp golden)
IBL_ASSETS = {"tex_0": ("scenes/assets/env.hdr", (64, 128, 3)),
              "tex_1": ("scenes/assets/checker.png", (128, 128, 3))}
IBL_GOLDEN_SPP = 48
# slice 16: the adaptive path (cornell.xml as pathtracing at 512², 4 passes
# on the scene's AA settings) and the time-to-RMSE protocol's step (128²,
# 64 samples a step; the plain shadow sum on every 4th of its 16,777,216
# NEE rays), then the main path at spp_batch 1, 4 and 16
ADAPTIVE_SIZE, ADAPTIVE_PASSES = 512, 4
# slice 17: the golden's spp (the reference's own gate), the card-vs-CPU
# render and the CLI's size
BIDIR_GOLDEN_SPP = 48
BIDIR_SMALL = dict(size=32, spp=4, cli_size=64, cli_spp=16)
LIGHTS = os.path.join(REPO, "scenes", "cornell_lights.xml")
LIGHTS_IES = "scenes/assets/cornell_lights.ies"  # as the scene names it
DENSE = ("closest_hit_dense", "shadow_logsum_dense")
LIGHTS_BIDIR_SPP = 16
# the photon variant: 200,000 + 100,000 photons, final gather 16, 16 spp
LIGHTS_PHOTON = dict(type="photonmapping", photons=200_000,
                     cPhotons=100_000, fg_samples=16)
LIGHTS_PHOTON_SPP = 16
LIGHTS_PHYSICS_RES = 128
SPB = dict(size=128, spb=64, plain_stride=4, sweep=(1, 4, 16))
# slice 20: ibl_passes.xml (ibl_spheres.xml with every pass and alpha); the
# card against the CPU at 32², 4 spp; film resume at 32²; the CLI at 64²,
# 4 spp.  The discrete planes may differ card to CPU in a few pixels (a
# grazing ray's hit, a rounding edge of toon's quantization).
IBL_PASSES = os.path.join(REPO, "scenes", "ibl_passes.xml")
PASSES_SMALL = dict(size=32, spp=4)
FILM_RESUME = dict(size=32)
PASSES_CLI = dict(size=64, spp=4)
DISCRETE_PASSES = frozenset(
    [p for p in PASS_NAMES if "-index-" in p] + ["shadow", "toon"])
TINY = ("closest_hit_tiny", "shadow_logsum_tiny")
# queries the plain gathers are compared and timed on (bounds their time);
# the culled kernel's two plain versions over 3.68 M photons take half
PLAIN_QUERIES = 16384
PLAIN_CULLED_QUERIES = 8192
PHOTON_TAGS = ("closest_tiny_kernel", "shadow_tiny_kernel",
               "density_flash_kernel", "density_sorted_kernel",
               "nearest_flash_kernel", "nearest_culled_kernel")
# slice 4: the generated mid-size scenes at the generator's own settings
# (512², 16 spp, bounces 3, gauss filter, one area light with 8 samples)
MID = (("dense", 1), ("stream", 2))  # (kernel pair, --grid), --subdiv 1
MID_CARD_VS_CPU = dict(size=32, spp=2)
# slice 5: the pair route on the grid path (GRID) and, at 32², 2 spp, on
# the 10,252-triangle grid (81 clusters of 128); the 131K random soup of
# the intersection benchmarks, soup131 (BT 1,024, 128 clusters)
PAIRS_SMALL = dict(grid=2, subdiv=3, size=32, spp=2)
SOUP = dict(tris=131072, rays=262144)
# a pack of more clusters than one sweep of closest_hit_fine's walk holds
# (256): 300,000 triangles in 293 clusters of 1,024
SWEEPS = dict(tris=300_000, rays=16384)
# slots the plain pair versions are compared and timed on (bounds their time)
PLAIN_SLOTS = 1 << 22
PAIR_KERNELS = ("pairs_closest_kernel", "pairs_shadow_kernel",
                "nearest_clusters_kernel", "closest_fine_kernel",
                "shadow_fine_kernel")
# the pair route's stages a profiled step splits its glue by
PAIR_STAGES = {"pairs.entries": (pi, "nearest_clusters"),
               "pairs.expand": (pi, "expand_pairs"),
               "pairs.route": (pi, "closest_hit_pairs"),
               "pairs.route_shadow": (pi, "shadow_logsum_pairs")}
# the bounds: NVIDIA H100 SXM datasheet peaks, FP32
# outside the tensor cores (counting a fused multiply-add as two; built with
# -fmad=false, the kernels can reach half of it) and device memory
FP32_PEAK = 67e12
HBM_RATE = 3.35e12
MT_OPS = 45  # one Möller-Trumbore pair test: 44 add/mul/sub + 1 division
BOX_OPS = 39  # one widened slab test: per axis 4 add/sub, 3 mul, 6 min/max
DENSITY_OPS = 13  # d2 (3 sub, 3 mul, 2 add), side test (3 mul, 2 add)
NEAREST_OPS = 8  # d2
BOX_D2_OPS = 20  # point-box d2: per axis 2 sub, 3 max; then 3 mul, 2 add


START = time.perf_counter()


def phase(tag: str, **kv) -> None:
    """One line per phase, ending with the seconds since the script
    started (at_s): the run's time budget, phase by phase."""
    kv["at_s"] = round(time.perf_counter() - START, 1)
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def nbytes(*tensors) -> int:
    """Bytes of the given tensors (a dict counts its tensors)."""
    out = 0
    for x in tensors:
        if isinstance(x, dict):
            out += nbytes(*x.values())
        elif isinstance(x, torch.Tensor):
            out += x.numel() * x.element_size()
    return out


def registers(source: str, kernel: str) -> dict:
    """Registers a thread of `kernel` (a substring of its mangled name) in
    csrc/<source>.cu uses and the bytes it spills, from the ptxas report
    kept beside its library."""
    name, out = None, {}
    with open(_build.library_path(source)[:-3] + ".log") as f:
        for line in f:
            if "Compiling entry function" in line:
                name = line
            elif name and kernel in name and "spill stores" in line:
                out["spill_stores"] = int(
                    re.search(r"(\d+) bytes spill stores", line).group(1))
            elif name and kernel in name and "registers" in line:
                out["registers"] = int(
                    re.search(r"Used (\d+) registers", line).group(1))
                return out
    raise AssertionError(f"ptxas reports no {kernel} in {source}.cu")


def bound(ops: float, moved: int, **work) -> dict:
    """The least time the card could take for a call: the larger of its
    FP32 operations over FP32_PEAK and the bytes it must move (each input
    read once, each output written once) over HBM_RATE; which of the two
    bounds it; and the work counted.  No single PyTorch call computes any
    of the port's kernels, so library_ms is None."""
    t_ops, t_bytes = 1e3 * ops / FP32_PEAK, 1e3 * moved / HBM_RATE
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                ops=ops, bytes=moved, library_ms=None, **work)


def cornell(size: int, spp: int, bounces: int, rr_min_bounces: int,
            device: str):
    """The port's main path inputs: parse -> build_config -> compile."""
    scene = parse_xml_file(CORNELL)
    scene.render_params["width"] = size
    scene.render_params["height"] = size
    cfg = build_config(scene)
    cfg = RenderConfig(**{**cfg.__dict__, "integrator": "pathtracing",
                          "bounces": bounces,
                          "rr_min_bounces": rr_min_bounces,
                          "width": size, "height": size,
                          "aa_samples": spp, "aa_passes": 1})
    return scene.compile(device=device), cfg


def make_grid(out_dir: str, grid: int, subdiv: int) -> str:
    """Write a grid-spheres scene with the port's generator at its default
    settings (512², 16 spp)."""
    return write_grid_spheres(
        os.path.join(out_dir, f"grid{grid}_{subdiv}.xml"), grid, subdiv)


def grid(path: str, size: int, spp: int, device: str, pairs: bool = False):
    """Slice 2's inputs: parse -> build_config (the scene's own pathtracing
    settings and gauss filter) -> compile (for the pair route with
    pairs=True)."""
    scene = parse_xml_file(path)
    scene.render_params["width"] = size
    scene.render_params["height"] = size
    cfg = build_config(scene)
    cfg = RenderConfig(**{**cfg.__dict__, "width": size, "height": size,
                          "aa_samples": spp, "aa_passes": 1})
    return scene.compile(device=device, pairs=pairs), cfg


def device_ms(fn, calls: int, replays: int = 5) -> float:
    """Device milliseconds per fn() call: `calls` back-to-back calls
    captured in one CUDA graph and replayed between one pair of CUDA
    events, the median over `replays` replays divided by `calls`.  The
    graph leaves the host's launch work out of the time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the capture stream, as capture asks
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        graph.replay()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1) / calls)
    return statistics.median(times)


def call_ms(fn, calls: int) -> float:
    """Milliseconds per eager fn() call, `calls` back-to-back calls between
    one pair of CUDA events: the device time or the host's launch work,
    whichever is longer, as the eager main path pays it."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(calls):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / calls


def once_ms(fn):
    """(fn()'s result, milliseconds between CUDA events around one eager
    call) for a call too long to repeat or capture."""
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    t1.synchronize()
    return out, t0.elapsed_time(t1)


def main_path_rays(cscene, cfg, arrays):
    """The kernels' inputs at the main path's shapes, made by the engine's
    own functions: the primary camera rays of sample 0 (H·W), and the first
    light's NEE shadow rays from their hit points (samples·H·W)."""
    dev = arrays["tri_geom_pack"].device
    st = cscene.static
    px, py, ph = engine.pixel_lanes(cfg.height, cfg.width, cfg.qmc_seed, dev)
    s_idx = torch.zeros_like(px)
    _, _, org, dirn, wt = engine.camera_rays(cscene.camera, px, py, ph,
                                             s_idx)
    alive = wt > 0.0
    primary = (org.contiguous(), dirn.contiguous(),
               *engine.ray_bounds(st, alive))
    hit = isect.closest_hit(arrays, st, *primary)
    sp = engine._surface_point(arrays, hit)
    n_sh, ng_sh = engine.shading_frame(sp, -dirn)
    ns = engine.nee_count(st.lights[0], cfg, full=True)
    smp, _, org_s, dist = engine.shadow_rays(
        arrays, st, 0, ns, sp["p"], n_sh, ng_sh, alive & hit.hit, s_idx,
        engine.bounce_key(ph, 0), qmc.bounce_dim(0, 0), static_dims=True)
    shadow = (org_s.contiguous(), smp["wi"].contiguous(), dist.contiguous())
    return primary, shadow


def check_kernels(cscene, cfg, arrays) -> list:
    st = cscene.static
    pack = arrays["tri_pack10"]
    logf = ci.log_filter(arrays["sfilt4_binary"])
    primary, shadow = main_path_rays(cscene, cfg, arrays)

    closest = check_tiny_closest(pack, primary, st.n_tris_real)
    tiny = check_tiny_shadow(pack, logf, shadow, st.n_stris_real)
    # one step's calls of the two kernels, recorded through the module
    # attributes the engine calls (closest_hit_tiny, and for
    # shadow_logsum_tiny shadow_transmission_tiny)
    rec = step_calls(cscene, cfg, ci, ("closest_hit_tiny",
                                       "shadow_transmission_tiny"))[2]
    c_calls = rec["closest_hit_tiny"]
    bounce_c = check_tiny_closest(c_calls[1][0], c_calls[1][1:5],
                                  c_calls[1][5], rays_name="bounce 1")
    check_old_body("closest_hit_tiny", c_calls)
    calls = [(pk, ci.log_filter(f4), *rays) for pk, f4, *rays in
             rec["shadow_transmission_tiny"]]
    bounce = check_tiny_shadow(*calls[1][:2], calls[1][2:5], calls[1][5],
                               rays="bounce-1 NEE")
    check_old_body("shadow_logsum_tiny", calls)
    return [
        dict(name="closest_hit_tiny", route="cuda",
             source=SRC.format("tiny_intersect"),
             replaces=PALLAS.format(2259),
             max_abs_err=max(closest["err"], bounce_c["err"]),
             **before_keys(closest, bounce_c), **closest["bound"]),
        dict(name="shadow_logsum_tiny", route="cuda",
             source=SRC.format("tiny_intersect"),
             replaces=PALLAS.format(2281),
             max_abs_err=max(tiny["err"], bounce["err"]), **before_keys(
                 tiny, bounce), **tiny["bound"]),
    ]


def check_tiny_closest(pack, rays, n_tris: int,
                       rays_name: str = "primary") -> dict:
    """closest_hit_tiny against its plain version (hit, tri equal, t, u, v
    within rtol 1e-4; and bit for bit in t, tri, u and v, again on a second
    call) and beside the one-thread body it replaced on the same rays
    (ms_before).  Its bound counts what each ray needs on the 2-column
    boxes its kernel builds (ci.tiny_boxes): a test of every real box for
    each live ray and the real columns of the groups its interval enters
    below min(tmax, t); pair_tests_made counts the pairs its walk lists
    (cx.closest_walk_pair_tests: it skips a listed item whose entry lies
    beyond the ray's best t when taken, so it makes at most these),
    box_tests_made its box tests, bound_ms_before every column for every
    ray (the one-thread body's work)."""
    org, dirn, tmin, tmax = rays
    kernel = lambda: ci.closest_hit_tiny(  # noqa: E731
        pack, *rays, n_tris)
    got = kernel()
    torch.cuda.synchronize()
    want = ci.closest_hit_tiny_plain(pack, *rays, n_tris)
    torch.cuda.synchronize()
    kt, ktri, ku, kv, khit = got
    pt, ptri, pu, pv, phit = want
    if not torch.equal(khit, phit) or not torch.equal(ktri[phit],
                                                      ptri[phit]):
        raise AssertionError(f"closest_hit_tiny: hit/tri differ from plain "
                             f"({rays_name})")
    for name, a, b in (("t", kt, pt), ("u", ku, pu), ("v", kv, pv)):
        if not torch.allclose(a[phit], b[phit], rtol=1e-4):
            raise AssertionError(f"closest_hit_tiny: {name} beyond rtol 1e-4 "
                                 f"({rays_name})")
    n_diff = differ(got[:4], want[:4])
    repeat = differ(kernel()[:4], got[:4])
    if n_diff or repeat:
        raise AssertionError(f"closest_hit_tiny: {n_diff} rays differ from "
                             f"plain, {repeat} from a second call "
                             f"({rays_name})")
    err = max(float((a[phit] - b[phit]).abs().max())
              for a, b in ((kt, pt), (ku, pu), (kv, pv)))
    ms = device_ms(kernel, calls=20)
    plain_ms = device_ms(lambda: ci.closest_hit_tiny_plain(
        pack, *rays, n_tris), calls=2)
    ms_before = device_ms(old_body("closest_hit_tiny", (
        pack, *rays, n_tris)), calls=20)
    boxes = torch.from_numpy(ci.tiny_boxes(pack.cpu().numpy(), n_tris)).to(
        pack.device)
    need = cx.cluster_pair_tests(pack, boxes, org, dirn, tmin,
                                 torch.minimum(tmax, kt), n_tris)[0]
    made, made_boxes = cx.closest_walk_pair_tests(pack, boxes, *rays, n_tris)
    box_tests = int((tmin <= tmax).sum()) * -(-n_tris // ci.TINY_GROUP)
    moved = nbytes(pack, *rays, kt, ktri, ku, kv)
    n = org.shape[0]
    before = bound(MT_OPS * n * n_tris, moved, pair_tests=n * n_tris)
    bnd = bound(MT_OPS * need + BOX_OPS * box_tests, moved, pair_tests=need,
                box_tests=box_tests)
    extra = dict(repeat_differ=repeat, ms_before=ms_before,
                 group=ci.TINY_GROUP, box_tests_made=made_boxes,
                 pair_tests_made=made, bound_ms_before=before["bound_ms"],
                 pair_tests_before=n * n_tris,
                 **registers("tiny_intersect", "closest_tiny_kernel"))
    phase("kernel", name="closest_hit_tiny", rays=rays_name, n=n,
          hits=int(phit.sum()), differ=n_diff, max_abs_err=err,
          tolerance="hit,tri equal; t,u,v rtol 1e-4; t,tri,u,v equal",
          ms=round(ms, 4), call_ms=round(call_ms(kernel, calls=20), 4),
          plain_ms=round(plain_ms, 4), **extra, **bnd)
    return dict(ms=ms, plain_ms=plain_ms, err=err, bound=bnd, extra=extra)


def differ(a: tuple, b: tuple) -> int:
    """Rays (entries of equal-shaped tensors) where any tensor of a differs
    from its counterpart in b."""
    out = torch.zeros_like(a[0], dtype=torch.bool)
    for x, y in zip(a, b):
        out |= x != y
    return int(out.sum())


def check_tiny_shadow(pack, logf, shadow, n_tris: int,
                      rays: str = "bounce-0 NEE", plain_stride: int = 1
                      ) -> dict:
    """shadow_logsum_tiny against its plain version (transmission atol
    2e-3; bit for bit, and again on a second call: the sum adds in the
    plain version's order; the plain version on every plain_stride-th ray
    where the batch is too large for its memory) and beside the one-thread
    body it replaced on the same rays (ms_before).  Its bound counts what each ray needs on the
    2-column boxes its kernel builds (ci.tiny_boxes): the real columns of
    the groups its segment enters and a test of every real box for each
    live ray; pair_tests_made counts what its walk tests (a thread's rays
    share their groups), bound_ms_before every column for every ray (the
    one-thread body's work)."""
    kernel = lambda: ci.shadow_logsum_tiny(  # noqa: E731
        pack, logf, *shadow, n_tris)
    klg = kernel()
    torch.cuda.synchronize()
    sub = shadow if plain_stride == 1 else tuple(
        x[::plain_stride].contiguous() for x in shadow)
    plg = ci.shadow_logsum_tiny_plain(pack, logf, *sub, n_tris)
    torch.cuda.synchronize()
    klg_sub = klg[::plain_stride]
    err = float((torch.exp(klg_sub) - torch.exp(plg)).abs().max())
    if err > 2e-3:
        raise AssertionError(f"shadow_logsum_tiny: transmission off by "
                             f"{err} > 2e-3 ({rays})")
    n_diff = int((klg_sub != plg).any(dim=-1).sum())
    del plg
    repeat = int((kernel() != klg).any(dim=-1).sum())
    if n_diff or repeat:
        raise AssertionError(f"shadow_logsum_tiny: {n_diff} rays differ from "
                             f"plain, {repeat} from a second call ({rays})")
    ms = device_ms(kernel, calls=20)
    plain_ms = device_ms(lambda: ci.shadow_logsum_tiny_plain(
        pack, logf, *sub, n_tris), calls=2)
    ms_before = device_ms(old_body("shadow_logsum_tiny", (
        pack, logf, *shadow, n_tris)), calls=20)
    org, dirn, dist = shadow
    boxes = torch.from_numpy(ci.tiny_boxes(pack.cpu().numpy(), n_tris)).to(
        pack.device)
    need = cx.cluster_pair_tests(pack, boxes, org, dirn,
                                 *cx.shadow_limits(dist), n_tris)[0]
    made, box_tests = cx.group_walk_pair_tests(
        boxes, org, dirn, dist, n_tris, width=ci.TINY_GROUP,
        rays_per_thread=ci.TINY_RAYS)
    moved = nbytes(pack, logf, *shadow, klg)
    n = org.shape[0]
    before = bound(MT_OPS * n * n_tris, moved, pair_tests=n * n_tris)
    bnd = bound(MT_OPS * need + BOX_OPS * box_tests, moved, pair_tests=need,
                box_tests=box_tests)
    extra = dict(repeat_differ=repeat, ms_before=ms_before,
                 rays_per_thread=ci.TINY_RAYS, group=ci.TINY_GROUP,
                 pair_tests_made=made, bound_ms_before=before["bound_ms"],
                 pair_tests_before=n * n_tris,
                 **registers("tiny_intersect", "shadow_tiny_kernel"))
    live = int((dist > 0).sum())
    opaque = int((klg <= -80.0).all(dim=-1).sum())
    phase("kernel", name="shadow_logsum_tiny", rays=rays, n=n, live=live,
          opaque=opaque, plain_rays=sub[0].shape[0], differ=n_diff,
          max_abs_err=err, tolerance="transmission atol 2e-3; equal",
          ms=round(ms, 4), call_ms=round(call_ms(kernel, calls=20), 4),
          plain_ms=round(plain_ms, 4), **extra, **bnd)
    return dict(ms=ms, plain_ms=plain_ms, err=err, bound=bnd, extra=extra,
                live=live, opaque=opaque)


def before_keys(first: dict, bounce: dict) -> dict:
    """The keys of a redesigned kernel's `kernels` entry beyond the common
    ones, from its bounce-0 and bounce-1 checks: the time of its first
    launch, of the old body on the same rays, both on the bounce-1 launch,
    the bounds of the two bodies, and the walk's work and registers."""
    ex, bx = first["extra"], bounce["extra"]
    return dict(
        ms=first["ms"], plain_ms=first["plain_ms"], ms_bounce=bounce["ms"],
        plain_ms_bounce=bounce["plain_ms"],
        bound_ms_bounce=bounce["bound"]["bound_ms"],
        ms_before=ex["ms_before"], ms_before_bounce=bx["ms_before"],
        bound_ms_before=ex["bound_ms_before"],
        bound_ms_before_bounce=bx["bound_ms_before"],
        pair_tests_before=ex["pair_tests_before"],
        pair_tests_made=ex["pair_tests_made"],
        registers=ex["registers"])


def check_fine_kernels(cscene, cfg, arrays) -> list:
    """The two large-scene kernels against their plain versions at the grid
    path's shapes: closest hit on the 262,144 primary rays of sample 0
    (hit, tri equal after the epilogue; t, u, v rtol 1e-4), shadows on the
    bounce-0 NEE rays (transmission atol 2e-3), each compared with the plain
    brute force on a strided sample (PLAIN_GRID_STRIDE)."""
    st = cscene.static
    pk, cl, sub = (arrays[k] for k in ("tri_pack10", "tri_cluster8",
                                       "tri_sub8"))
    n_tris = st.n_tris_real
    logf = ci.log_filter(arrays["sfilt4_binary"])
    primary, shadow = main_path_rays(cscene, cfg, arrays)
    org, dirn = primary[0], primary[1]

    kt, kcol = fi.closest_hit_fine(pk, cl, sub, *primary, n_tris)
    torch.cuda.synchronize()
    sample_c = tuple(x[::PLAIN_GRID_STRIDE["closest"]].contiguous()
                     for x in primary)
    (pt, pcol), plain_ms_c = once_ms(
        lambda: fi.closest_fine_plain(pk, *sample_c, n_tris))
    kt_c, kcol_c = (x[::PLAIN_GRID_STRIDE["closest"]] for x in (kt, kcol))
    k_hit = fi.closest_epilogue(pk, *sample_c[:2], kt_c, kcol_c, n_tris)
    p_hit = fi.closest_epilogue(pk, *sample_c[:2], pt, pcol, n_tris)
    phit = p_hit[4]
    if not torch.equal(k_hit[4], phit) or not torch.equal(k_hit[1][phit],
                                                          p_hit[1][phit]):
        raise AssertionError("closest_hit_fine: hit/tri differ from plain")
    for name, i in (("t", 0), ("u", 2), ("v", 3)):
        if not torch.allclose(k_hit[i][phit], p_hit[i][phit], rtol=1e-4):
            raise AssertionError(f"closest_hit_fine: {name} beyond rtol 1e-4")
    n_diff = int(((kt_c != pt) | (kcol_c != pcol)).sum())
    n_rays = kt.shape[0]
    n_cmp = pt.shape[0]
    err_c = max(float((k_hit[i][phit] - p_hit[i][phit]).abs().max())
                for i in (0, 2, 3))
    kernel_c = lambda: fi.closest_hit_fine(  # noqa: E731
        pk, cl, sub, *primary, n_tris)
    ms_c = device_ms(kernel_c, calls=5, replays=3)
    call_ms_c = call_ms(kernel_c, calls=5)
    ms_c_sub = device_ms(lambda: fi.closest_hit_fine(
        pk, cl, sub, *sample_c, n_tris), calls=5, replays=3)
    pairs_c, boxes_c = fi.fine_pair_tests(
        cl, sub, org, dirn, primary[2], torch.minimum(primary[3], kt),
        n_tris)
    bound_c = bound(MT_OPS * pairs_c + BOX_OPS * boxes_c,
                    nbytes(pk, cl, sub, *primary, kt, kcol),
                    pair_tests=pairs_c, box_tests=boxes_c,
                    **walk_bracket(cl, sub, *primary, n_tris))
    phase("kernel", name="closest_hit_fine", tris=n_tris, rays=n_rays,
          compared_rays=n_cmp, hits=int(phit.sum()), differ=n_diff,
          max_abs_err=err_c, tolerance="hit,tri equal; t,u,v rtol 1e-4",
          ms=round(ms_c, 4), call_ms=round(call_ms_c, 4),
          ms_on_compared=round(ms_c_sub, 4), plain_ms=round(plain_ms_c, 4),
          plain=f"one eager call on every "
          f"{PLAIN_GRID_STRIDE['closest']}th ray", **bound_c)

    klg = fi.shadow_logsum_fine(pk, cl, sub, logf, *shadow, n_tris)
    torch.cuda.synchronize()
    sub_rays = tuple(x[::PLAIN_GRID_STRIDE["shadow"]].contiguous()
                     for x in shadow)
    plg, plain_ms_s = once_ms(
        lambda: fi.shadow_logsum_fine_plain(pk, logf, *sub_rays, n_tris))
    klg_sub = klg[::PLAIN_GRID_STRIDE["shadow"]]
    err_s = float((torch.exp(klg_sub) - torch.exp(plg)).abs().max())
    if err_s > 2e-3:
        raise AssertionError(f"shadow_logsum_fine: transmission off by "
                             f"{err_s} > 2e-3")
    n_diff_s = int((klg_sub != plg).any(dim=-1).sum())
    kernel_s = lambda: fi.shadow_logsum_fine(  # noqa: E731
        pk, cl, sub, logf, *shadow, n_tris)
    ms_s = device_ms(kernel_s, calls=3, replays=3)
    call_ms_s = call_ms(kernel_s, calls=3)
    ms_s_sub = device_ms(lambda: fi.shadow_logsum_fine(
        pk, cl, sub, logf, *sub_rays, n_tris), calls=5, replays=3)
    n_sh = shadow[0].shape[0]
    pairs_s, boxes_s = fi.fine_pair_tests(
        cl, sub, shadow[0], shadow[1], *cx.shadow_limits(shadow[2]), n_tris)
    bound_s = bound(MT_OPS * pairs_s + BOX_OPS * boxes_s,
                    nbytes(pk, cl, sub, logf, *shadow, klg),
                    pair_tests=pairs_s, box_tests=boxes_s)
    phase("kernel", name="shadow_logsum_fine", tris=n_tris, rays=n_sh,
          live=int((shadow[2] > 0).sum()), compared_rays=plg.shape[0],
          differ=n_diff_s, max_abs_err=err_s,
          tolerance="transmission atol 2e-3", ms=round(ms_s, 4),
          call_ms=round(call_ms_s, 4), ms_on_compared=round(ms_s_sub, 4),
          plain_ms=round(plain_ms_s, 4),
          plain=f"one eager call on every "
          f"{PLAIN_GRID_STRIDE['shadow']}th ray", **bound_s)
    return [
        dict(name="closest_hit_fine", route="cuda",
             source=SRC.format("fine_intersect"),
             replaces=PALLAS.format(910), max_abs_err=err_c, ms=ms_c,
             plain_ms=plain_ms_c, rays=n_rays, plain_rays=n_cmp,
             ms_on_plain_rays=ms_c_sub, **bound_c),
        dict(name="shadow_logsum_fine", route="cuda",
             source=SRC.format("fine_intersect"),
             replaces=PALLAS.format(1019), max_abs_err=err_s, ms=ms_s,
             plain_ms=plain_ms_s, rays=n_sh,
             plain_rays=plg.shape[0], ms_on_plain_rays=ms_s_sub,
             **bound_s),
    ]


def walk_bracket(cl, sub, org, dirn, tmin, tmax, n_tris) -> dict:
    """The most a closest-hit walk can need: the pair and box tests of
    every box the whole interval [tmin, tmax] enters (a walk that never
    culls by its best t).  With the bound's count (boxes entered before
    the hit) it brackets what a walk tests."""
    pairs, boxes = fi.fine_pair_tests(cl, sub, org, dirn, tmin, tmax, n_tris)
    return dict(pair_tests_no_cull=pairs, box_tests_no_cull=boxes)


# every kernel wrapper of the port, by name: each counts its launches
WRAPPERS = {fn.__name__: fn for fn in (
    ci.closest_hit_tiny, ci.shadow_logsum_tiny, fi.closest_hit_fine,
    fi.shadow_logsum_fine, pf.density_flash, pf.nearest_flash,
    pf.density_culled, cx.closest_hit_dense, cx.shadow_logsum_dense,
    cx.closest_hit_stream, cx.shadow_logsum_stream, pi.pairs_closest,
    pi.pairs_shadow, pi.nearest_clusters, bt.closest_hit_bvh,
    bt.shadow_logsum_bvh)}


def counted(run):
    """run() with every launch counter set to 0 just before and read just
    after: (result, {wrapper name: launches})."""
    for fn in WRAPPERS.values():
        fn.launches = 0
    out = run()
    return out, {k: fn.launches for k, fn in WRAPPERS.items()}


def render_counted(cscene, cfg, names: tuple):
    """render_timed on the card, counted; returns the launches of `names`
    and raises if any other kernel launched."""
    res, launches = counted(lambda: render_timed(cscene, cfg, device="cuda"))
    others = {k: v for k, v in launches.items() if k not in names and v}
    if others:
        raise AssertionError(f"kernels off the path launched: {others}")
    return res, {k: launches[k] for k in names}


def check_path(tag, res, cfg, launches, smi) -> None:
    """One path's phase line, and its image and launch checks: each
    kernel launches once per path vertex of every step, the warm-up step
    included."""
    img = res.image
    want = (cfg.bounces + 1) * (cfg.aa_samples + 1)
    phase(tag, size=f"{cfg.width}x{cfg.height}", spp=cfg.aa_samples,
          bounces=cfg.bounces, render_s=round(res.stats["render_s"], 4),
          rays=res.stats["rays"], mrays_per_s=round(res.mrays_per_sec, 3),
          launches=launches, expected_launches=want, gpu=repr(smi))
    if not np.all(np.isfinite(img)) or img.min() < 0.0:
        raise AssertionError(f"{tag}: image is not finite and >= 0")
    for k, v in launches.items():
        if v != want:
            raise AssertionError(f"{k}: {v} launches, expected {want}")


# ---- the untimed checks, run together after the timed phases ---------------
# A card-against-CPU phase renders one call on the card (kernels) and on the
# CPU (plain versions) and compares them; a golden renders on the card and
# compares with a stored image.  Nothing in either is timed, so they run
# after every timed phase, in one block (`run_deferred`): the goldens go to
# CARD_WORKERS spawned processes on the card, the CPU renders of every
# queued card-against-CPU phase to CPU_WORKERS spawned processes, all at
# once, and this process resumes each card-against-CPU phase in turn (its
# card half, then its comparison as its CPU renders come back).  A
# card-against-CPU phase is a generator that yields its CPU renders as
# picklable (fn, args, kwargs) calls and takes their results back; `defer`
# queues it, `defer_card` queues a card-only check (a module-level
# function, whose phase lines this process prints when it is done).  The
# block's phase lines keep their tags.
CPU_WORKERS, CPU_THREADS, CARD_WORKERS = 4, 2, 2
DEFERRED: list = []
DEFERRED_CARD: list = []


def defer(gen) -> None:
    """Queue a card-against-CPU phase: run it up to its CPU renders."""
    DEFERRED.append((gen, next(gen)))


def defer_card(fn, *args) -> None:
    """Queue an untimed card-only check (a golden)."""
    DEFERRED_CARD.append((fn, args))


def cpu_call(fn, args: tuple, kwargs: dict):
    """One queued CPU render, in a worker process."""
    return fn(*args, **kwargs)


def card_call(fn, args: tuple) -> list:
    """One queued card-only check, in a worker process: its phase lines
    are returned as (tag, fields), for the parent to print."""
    global phase
    lines, printing = [], phase
    phase = lambda tag, **kv: lines.append((tag, kv))  # noqa: E731
    try:
        fn(*args)
    finally:
        phase = printing
    return lines


def run_deferred() -> None:
    """The block of queued checks (comment above DEFERRED)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    t0 = time.perf_counter()
    n_cpu = sum(len(specs) for _, specs in DEFERRED)
    spawn = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(CARD_WORKERS, mp_context=spawn) as cards, \
            ProcessPoolExecutor(CPU_WORKERS, mp_context=spawn,
                                initializer=torch.set_num_threads,
                                initargs=(CPU_THREADS,)) as pool:
        golden = [cards.submit(card_call, fn, args)
                  for fn, args in DEFERRED_CARD]
        futures = [[pool.submit(cpu_call, *spec) for spec in specs]
                   for _, specs in DEFERRED]
        for (gen, _), futs in zip(DEFERRED, futures):
            try:
                gen.send([f.result() for f in futs])
            except StopIteration:
                continue
            raise AssertionError("a card-against-CPU phase yielded twice")
        for f in golden:
            for tag, kv in f.result():
                phase(tag, **kv)
    phase("untimed_checks", card_vs_cpu_phases=len(DEFERRED),
          cpu_renders=n_cpu, card_checks=len(DEFERRED_CARD),
          cpu_workers=CPU_WORKERS, cpu_threads=CPU_THREADS,
          card_workers=CARD_WORKERS,
          seconds=round(time.perf_counter() - t0, 3))
    DEFERRED.clear()
    DEFERRED_CARD.clear()


def card_vs_cpu(tag, make, size, spp) -> None:
    """The same render on the card (kernels) and the CPU (plain versions):
    RMSE <= 1e-4 and rays within 0.01% (deferred: `defer`).  make(device)
    -> (compiled scene, config), called for both devices now."""
    defer(_card_vs_cpu(tag, make, size, spp))


def _card_vs_cpu(tag, make, size, spp):
    card = make("cuda")
    (cpu,) = yield [(render, make("cpu"), dict(device="cpu"))]
    out = dict(cpu=cpu, cuda=render(*card, device="cuda"))
    rmse = float(np.sqrt(np.mean((out["cuda"].image
                                  - out["cpu"].image) ** 2)))
    r_gpu, r_cpu = out["cuda"].stats["rays"], out["cpu"].stats["rays"]
    rel = abs(r_gpu - r_cpu) / max(r_cpu, 1.0)
    phase(tag, size=f"{size}x{size}", spp=spp, rmse=rmse, bound=1e-4,
          rays_gpu=r_gpu, rays_cpu=r_cpu, rays_rel=rel)
    if not (rmse <= 1e-4 and rel <= 1e-4):
        raise AssertionError(f"{tag}: card and CPU renders disagree")


class _TraceEvent:
    """One event of a profiler trace, as torch's parse keeps it (its
    FunctionEvent): times in µs from the trace's start, the demangled
    name, the device, the thread, async-ness, the correlation ids, the
    device kernels it launched (their µs) and its CPU children."""

    __slots__ = ("start", "end", "name", "device", "thread", "is_async",
                 "id", "linked", "kernels", "children", "parent",
                 "annotation", "taken", "_total")

    def __init__(self, e, t0, name):
        self.start = (e.start_ns() - t0) / 1000
        self.end = (e.end_ns() - t0) / 1000
        self.name = name
        self.device = e.device_type()
        self.thread = e.start_thread_id()
        self.is_async = e.is_async() or (self.thread != e.end_thread_id())
        self.id = e.correlation_id()
        self.linked = e.linked_correlation_id()
        self.annotation = e.is_user_annotation()
        self.kernels, self.children, self.parent, self._total = \
            [], [], None, None
        self.taken = False  # a device event an op's `kernels` holds

    def device_time_total(self, cpu) -> float:
        """FunctionEvent.device_time_total: a sync CPU event's kernels and
        its children's totals; a device event's own length."""
        if self._total is None:
            if self.is_async:
                self._total = 0
            elif self.device == cpu:
                self._total = sum(self.kernels) + sum(
                    ch.device_time_total(cpu) for ch in self.children)
            else:
                self._total = self.end - self.start
        return self._total


def trace_events(prof) -> list:
    """The events of a finished torch.profiler run with their kernels, CPU
    parents and children, as torch's own parse and tree build give them
    (autograd.profiler `_parse_kineto_results`, EventList `_build_tree`:
    kernels join the op of their linked correlation id, a sync CPU event
    is the child of the innermost one on its thread whose interval holds
    it, a lone child of its own name is merged into its parent), read
    straight from the raw kineto events: a fraction of the time of
    building FunctionEvents for ~90,000 events a step."""
    from itertools import groupby

    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import _filter_name, _rewrite_name

    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    names: dict = {}
    events, corr, front = [], {}, []
    for e in res.events():
        raw = e.name()
        if _filter_name(raw) or getattr(e, "is_hidden_event",
                                        lambda: False)():
            continue
        name = names.get(raw)
        if name is None:
            name = names[raw] = _rewrite_name(name=raw, with_wildcard=True)
        ev = _TraceEvent(e, t0, name)
        events.append(ev)
        if ev.linked > 0:
            corr.setdefault(ev.linked, []).append(ev)
        elif ev.linked == 0:
            front.append(ev)
    cpu = DeviceType.CPU
    for fe in front:
        if fe.device == cpu and not fe.is_async and fe.id in corr:
            for f in corr[fe.id]:
                if f.device == cpu:
                    f.thread = fe.thread
                else:
                    fe.kernels.append(f.end - f.start)
                    f.taken = True
    events.sort(key=lambda ev: (ev.start, -ev.end))
    # a stable sort by thread keeps each thread's events in start order
    sync = sorted((ev for ev in events
                   if not ev.is_async and ev.device == cpu),
                  key=lambda ev: ev.thread)
    for _, thread in groupby(sync, key=lambda ev: ev.thread):
        stack = []
        for ev in thread:
            while stack:
                top = stack[-1]
                if ev.start >= top.end or ev.end > top.end:
                    stack.pop()
                else:
                    top.children.append(ev)
                    ev.parent = top
                    break
            stack.append(ev)
    while True:  # EventList._remove_dup_nodes
        drop = set()
        for i, ev in enumerate(events):
            p = ev.parent
            if p is not None and p.name == ev.name and len(p.children) == 1:
                p.children = ev.children
                p.kernels = ev.kernels
                for ch in ev.children:
                    ch.parent = p
                drop.add(i)
        if not drop:
            return events
        events = [ev for i, ev in enumerate(events) if i not in drop]


def _stage_ms(events, stages) -> dict:
    """Device ms of the kernels launched inside each `stages` range (the
    innermost one): an aten op's by the events' kernel and parent links;
    a kernel no op took (the port's own, launched through ctypes) by the
    CUDA runtime call that launched it, which carries its correlation
    id."""
    from torch.autograd import DeviceType

    out = dict.fromkeys(stages, 0.0)

    def add(e, ms):
        while e is not None and e.name not in out:
            e = e.parent
        if e is not None:
            out[e.name] += ms

    launch = {e.id: e for e in events
              if e.device == DeviceType.CPU and e.name.startswith("cu")}
    for e in events:
        if e.kernels:
            add(e, sum(e.kernels) / 1e3)
        elif (e.device != DeviceType.CPU and not e.taken
              and e.name not in out and e.id in launch):
            add(launch[e.id], (e.end - e.start) / 1e3)
    return {k: round(v, 4) for k, v in out.items()}


def trace_summary(events, kernel_tags: tuple, stages: dict | None) -> dict:
    """What profile_step reports of a profiled step's events: its kernel
    launches, the device's busy ms (the union of its kernel and copy
    intervals), the ported kernels' ms (those whose names hold one of
    `kernel_tags`: in all, a launch each in launch order, and per tag as
    ms / launches), the aten ops with the most device time (ms / calls,
    by name as key_averages sums them) and, with `stages`, the device ms
    of the aten kernels inside each stage range."""
    from torch.autograd import DeviceType

    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    # the stage ranges also appear on the device's timeline (as user
    # annotations spanning their kernels): they are no device work
    spans = sorted((e.start, e.end, e.name) for e in events
                   if e.device == cuda and e.name not in (stages or {}))
    if not spans:
        return dict(device_busy_ms="not measured")
    busy_us, end = 0.0, float("-inf")
    for a, b, _ in spans:
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    totals: dict = {}
    for e in events:  # key_averages: (name, device, annotation) groups
        key = (e.name, e.device, e.annotation)
        t = totals.setdefault(key, [0, 0])
        t[0] += e.device_time_total(cpu)
        t[1] += 1
    ops = sorted(((k[0], v) for k, v in totals.items()
                  if k[0].startswith("aten::") and v[0] > 0),
                 key=lambda kv: -kv[1][0])[:6]
    ported = [(next(t for t in kernel_tags if t in n), (b - a) / 1e3)
              for a, b, n in spans if any(t in n for t in kernel_tags)]
    by_tag = {t: [ms for k, ms in ported if k == t] for t in kernel_tags}
    extra = {}
    if stages:
        extra["stage_ms"] = _stage_ms(events, stages)
    return dict(
        kernel_launches=sum(not n.startswith(("Memcpy", "Memset"))
                            for _, _, n in spans),
        device_busy_ms=busy_us / 1e3,
        ported_ms=sum(ms for _, ms in ported),
        ported_calls_ms=[round(ms, 4) for _, ms in ported],
        ported_by_kernel={t: f"{sum(v):.4f}ms/{len(v)}"
                          for t, v in by_tag.items()},
        top_ops={k: f"{tot / 1e3:.4f}ms/{n}" for k, (tot, n) in ops},
        **extra)


def profile_step(step, arrays, cfg, kernel_tags: tuple,
                 stages: dict | None = None, arg=None, film=None) -> dict:
    """One sample step under torch.profiler, after an unprofiled one:
    `trace_summary` of its events (`trace_events`).  `stages` ({range
    name: (module, function name)}) wraps those functions in profiler
    ranges for the profiled step.  arg: the step's third argument (a
    compact step's lane list; default every pixel's flag); film: a
    function that makes the step's first film (default the plain
    film)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    dev = engine.resolve_device("cuda")
    flags = (torch.ones((cfg.height, cfg.width), dtype=torch.bool, device=dev)
             if arg is None else arg)
    film = step(arrays, film() if film else _fresh_film(cfg, dev), flags)
    torch.cuda.synchronize()
    saved = {}
    for name, (module, fn_name) in (stages or {}).items():
        fn = saved[(module, fn_name)] = getattr(module, fn_name)

        def ranged(*a, _fn=fn, _name=name, **k):
            with record_function(_name):
                return _fn(*a, **k)
        setattr(module, fn_name, ranged)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(arrays, film, flags)
            torch.cuda.synchronize()
    finally:
        for (module, fn_name), fn in saved.items():
            setattr(module, fn_name, fn)
    return trace_summary(trace_events(prof), kernel_tags, stages)


def profile(tag, res, step, arrays, cfg, kernel_tags, smi,
            stages=None) -> dict:
    """The profile phase line of a path: one step profiled, its wall time
    the path's unprofiled render_s per sample.  Returns the line's
    fields."""
    step_ms = 1e3 * res.stats["render_s"] / cfg.aa_samples
    prof = profile_step(step, arrays, cfg, kernel_tags, stages)
    busy = prof["device_busy_ms"]
    out = dict(step_ms=round(step_ms, 3), **prof,
               busy_share=(busy / step_ms if isinstance(busy, float)
                           else "not measured"))
    phase(tag, **out, gpu=repr(smi))
    return out


def path_step(cscene, cfg):
    """A pathtracing sample step on the card and its scene tensors."""
    dev = engine.resolve_device("cuda")
    return (engine.make_sample_step(cscene.static, cscene.camera, cfg, dev),
            to_tensors(cscene.arrays, dev))


# ---- slice 3: photon mapping ----------------------------------------------


def photon_scene(path: str, device: str, size: int = 0, **over):
    """Slice 3's inputs: parse -> build_config (the scene's own settings,
    then `over`) -> compile.  size=0 keeps the scene's resolution."""
    scene = parse_xml_file(path)
    if size:
        scene.render_params["width"] = size
        scene.render_params["height"] = size
    cfg = build_config(scene)
    if size:
        over = dict(over, width=size, height=size)
    cfg = RenderConfig(**{**cfg.__dict__, **over})
    return scene.compile(device=device), cfg


def record_calls(module, names, run):
    """run() with the functions `names` of `module` recording their
    positional arguments.  Returns (run's result, [(name, args)])."""
    calls = []
    saved = {k: getattr(module, k) for k in names}

    def recorder(name, fn):
        def call(*args, **kwargs):
            calls.append((name, args + tuple(kwargs.values())))
            return fn(*args, **kwargs)
        return call

    for k, fn in saved.items():
        setattr(module, k, recorder(k, fn))
    try:
        out = run()
    finally:
        for k, fn in saved.items():
            setattr(module, k, fn)
    return out, calls


def gather_calls(run):
    """run() with photonmap's gathers (density_auto, nearest_flash) and
    the functions that pack the maps (the diffuse, then the caustic map;
    the radiance map) recording their arguments."""
    return record_calls(photonmap, ("density_auto", "nearest_flash",
                                    "make_photon_pack_auto",
                                    "make_photon_pack_lookup"), run)


def photon_inputs(cscene, cfg):
    """The gathers' arguments as the photon path makes them: the maps are
    built and installed, then one sample step runs.  Returns (step,
    arrays, pre_calls, step_calls): the step and its scene tensors with
    the packs, the radiance-map precompute's density gathers (one per
    65,536 queries) and the step's caustic density and fg_samples nearest
    lookups."""
    dev = engine.resolve_device("cuda")
    arrays = to_tensors(cscene.arrays, dev)
    maps, pre_calls = gather_calls(
        lambda: photonmap.install_photon_maps(cscene, cfg, arrays))
    step = photonmap.make_photon_sample_step(cscene, cfg, maps, dev)
    flags = torch.ones((cfg.height, cfg.width), dtype=torch.bool, device=dev)
    _, step_calls = gather_calls(
        lambda: step(arrays, _fresh_film(cfg, dev), flags))
    torch.cuda.synchronize()
    return step, arrays, pre_calls, step_calls


def compare_density(what, kernel, plain, pack, qp, qn, r, sample):
    """kernel(pack, qp, qn, r) against plain(...) on the queries
    `sample` (a slice): counts equal, flux within rtol 1e-5 / atol 1e-6 of
    the flux scale.  Returns (kernel result, differ, max_abs_err, plain
    ms)."""
    kf, kc = kernel(pack, qp, qn, r)
    torch.cuda.synchronize()
    (pf_, pc), plain_ms = once_ms(
        lambda: plain(pack, qp[sample], qn[sample], r))
    differ = int((kc[sample] != pc).sum())
    scale = float(pf_.abs().max())
    err = float((kf[sample] - pf_).abs().max())
    if differ:
        raise AssertionError(f"{what}: {differ} counts differ from plain")
    if not torch.allclose(kf[sample], pf_, rtol=1e-5, atol=1e-6 * scale):
        raise AssertionError(f"{what}: flux beyond rtol 1e-5 (err {err})")
    return (kf, kc), differ, err, plain_ms


def radius_text(r) -> str:
    """A gather's radius for a phase line: the scalar, or the range of the
    per-query radii."""
    if isinstance(r, torch.Tensor):
        return f"per query {float(r.min()):.6g}-{float(r.max()):.6g}"
    return f"{r:.6g}"


def valid_photons(pack: dict) -> int:
    """Photons of a flash pack not at the sentinel (the pairs the brute
    force needs per query)."""
    return int((pack["pos_t"][0] < 0.5 * pf.SENTINEL).sum())


def check_density(what: str, args, photons) -> dict:
    """density_flash on one of the path's sorted packs (the warp-per-query
    search) against density_flash_plain on its flash view (every query:
    counts equal, flux rtol 1e-5), against the brute-force kernel over the
    same photons in their original order (`photons`, the pack's recorded
    arguments), and against itself (two calls bit for bit); ms, and
    ms_before the brute force's.  The bound counts the pairs of the
    clusters within each query's radius and one box test a cluster;
    bound_ms_before the brute force's pairs."""
    pack, qp, qn, r = args
    if pf.pack_layout(pack) != "sorted":
        raise AssertionError(f"density_flash ({what}): the path's pack is "
                             "not the sorted layout")
    n = qp.shape[0]
    (kf, kc), differ, err, plain_ms = compare_density(
        "density_flash", pf.density_flash,
        lambda p, *a: pf.density_flash_plain(pf.flash_view(p), *a),
        pack, qp, qn, r, slice(None))
    af, ac = pf.density_flash(pack, qp, qn, r)
    brute = pf.make_photon_pack(*photons)
    bf, bc = pf.density_flash(brute, qp, qn, r)
    torch.cuda.synchronize()
    repeat = int(((af != kf).any(dim=1) | (ac != kc)).sum())
    differ_b = int((bc != kc).sum())
    err_b = float((bf - kf).abs().max())
    if brute["pos_t"].shape[1] != pack["tbl"].shape[1] or differ_b or repeat:
        raise AssertionError(f"density_flash ({what}): {differ_b} counts "
                             f"differ from the brute force's, {repeat} "
                             "from a second call")
    if not torch.allclose(kf, bf, rtol=1e-5, atol=1e-6 * float(
            bf.abs().max())):
        raise AssertionError(f"density_flash ({what}): flux beyond rtol 1e-5 "
                             f"of the brute force's (err {err_b})")
    kernel = lambda: pf.density_flash(pack, qp, qn, r)  # noqa: E731
    ms = device_ms(kernel, calls=3, replays=3)
    ms_before = device_ms(lambda: pf.density_flash(brute, qp, qn, r),
                          calls=2, replays=3)
    pairs, boxes = pf.culled_pair_tests(pack, qp, r)
    bnd = bound(DENSITY_OPS * pairs + BOX_D2_OPS * boxes,
                nbytes(pack["tbl"][0:9], pack["cl_lo"], pack["cl_hi"], qp,
                       qn) + 4 * n + 16 * n,
                pair_tests=pairs, box_tests=boxes)
    pairs_b = n * valid_photons(brute)
    bnd_b = bound(DENSITY_OPS * pairs_b,
                  nbytes(brute, qp, qn) + 4 * n + 16 * n)
    regs = registers("photon_flash", "density_sorted_kernel")
    phase("kernel", name="density_flash", gather=what, queries=n,
          photons=int(pack["n_valid"]), pack=pack["tbl"].shape[1],
          clusters=pack["cl_lo"].shape[0], radius=radius_text(r),
          counted=int(kc.sum()), differ=differ, max_abs_err=err,
          differ_vs_brute=differ_b, max_abs_err_vs_brute=err_b,
          repeat_differ=repeat,
          tolerance="counts equal; flux rtol 1e-5, atol 1e-6*scale",
          ms=round(ms, 4), ms_before=round(ms_before, 4),
          call_ms=round(call_ms(kernel, 3), 4),
          plain_ms=round(plain_ms, 4),
          plain="density_flash_plain on the flash view, one eager call",
          **regs, clusters_per_query=round(pairs / pf.BP / n, 3),
          bound_ms_before=bnd_b["bound_ms"], pair_tests_before=pairs_b,
          **bnd)
    return dict(ms=ms, plain_ms=plain_ms, err=err, ms_before=ms_before,
                bound=bnd, bound_before=bnd_b, regs=regs)


def check_nearest(nearest, photons, label: str = "") -> dict:
    """nearest_flash at a step's final-gather lookup (`nearest`, its
    recorded arguments): the culled search on the path's sorted pack
    against the brute-force kernel on the same photons in their original
    order (`photons`, the radiance pack's recorded arguments), on every
    query (found and best d2 equal, values rtol 1e-5), each kernel against
    its plain version on the first PLAIN_QUERIES queries."""
    pack, qp, r = nearest
    if "tbl" not in pack:
        raise AssertionError("nearest_flash: the path's radiance pack is "
                             "not the sorted layout")
    flash = pf.make_photon_pack(*photons)
    n = PLAIN_QUERIES
    nq = qp.shape[0]
    kv, kbest = pf.nearest_flash_best(pack, qp, r)
    bv, bbest = pf.nearest_flash_best(flash, qp, r)
    torch.cuda.synchronize()
    kfound = torch.isfinite(kbest)
    scale = float(bv.abs().max())
    differ_b = int((kbest != bbest).sum())
    err_b = float((kv - bv).abs().max())
    if differ_b or not torch.allclose(kv, bv, rtol=1e-5, atol=1e-6 * scale):
        raise AssertionError(f"nearest_flash: {differ_b} best d2 differ from "
                             f"the brute-force kernel's, value err {err_b}")
    err, differ_p = 0.0, 0
    plain_ms = {}
    for what, kernel_v, kernel_best, plain, p in (
            ("culled", kv, kbest, pf.nearest_culled_plain, pack),
            ("brute", bv, bbest, pf.nearest_flash_plain, flash)):
        (pv, pfound), plain_ms[what] = once_ms(lambda: plain(p, qp[:n], r))
        differ = int((torch.isfinite(kernel_best[:n]) != pfound).sum())
        e = float((kernel_v[:n] - pv).abs().max())
        err, differ_p = max(err, e), max(differ_p, differ)
        if differ or not torch.allclose(kernel_v[:n], pv, rtol=1e-5,
                                        atol=1e-6 * scale):
            raise AssertionError(f"nearest_flash ({what}): {differ} found "
                                 f"flags differ from plain, value err {e}")
    kernel = lambda: pf.nearest_flash(pack, qp, r)  # noqa: E731
    brute = lambda: pf.nearest_flash(flash, qp, r)  # noqa: E731
    ms_n = device_ms(kernel, calls=4, replays=3)
    ms_brute = device_ms(brute, calls=2, replays=3)
    ms_n_sub = device_ms(lambda: pf.nearest_flash(pack, qp[:n], r),
                         calls=5, replays=3)
    moved = nbytes(pack["tbl"][0:3], pack["tbl"][6:10], pack["cl_lo"],
                   pack["cl_hi"], qp) + 4 * nq + 16 * nq
    pairs, boxes = pf.nearest_pair_tests(pack, qp, r, kbest)
    bnd = bound(NEAREST_OPS * pairs + BOX_D2_OPS * boxes, moved,
                pair_tests=pairs, box_tests=boxes)
    pairs_b = nq * valid_photons(flash)
    bnd_b = bound(NEAREST_OPS * pairs_b,
                  nbytes(flash["pos_t"], flash["val"], qp) + 4 * nq + 16 * nq)
    phase("kernel", name="nearest_flash",
          **({"gather": label} if label else {}),
          queries=nq,
          photons=pack["tbl"].shape[1], clusters=pack["cl_lo"].shape[0],
          radius=r, compared_queries=n, found=int(kfound.sum()),
          differ=differ_p, differ_vs_brute=differ_b, max_abs_err=err,
          max_abs_err_vs_brute=err_b,
          tolerance="found, best d2 equal; value rtol 1e-5",
          ms=round(ms_n, 4), ms_before=round(ms_brute, 4),
          call_ms=round(call_ms(kernel, 4), 4),
          ms_on_compared=round(ms_n_sub, 4),
          plain_ms=round(plain_ms["culled"], 4),
          plain_ms_brute=round(plain_ms["brute"], 4),
          plain=f"one eager call on the first {n} queries",
          bound_ms_before=bnd_b["bound_ms"], pair_tests_before=pairs_b,
          clusters_per_query=round(pairs / pf.BP / nq, 3), **bnd)
    return dict(err=err, ms=ms_n, plain_ms=plain_ms["culled"],
                plain_queries=n, ms_on_plain_queries=ms_n_sub,
                ms_brute=ms_brute, bound_brute=bnd_b,
                pair_tests_brute=pairs_b, bound=bnd)


def check_photon_kernels(pre_calls, step_calls) -> list:
    """density_flash at both of the path's shapes (the step's caustic
    gather, the first radiance-map precompute gather: `check_density`), and
    nearest_flash at the step's first final-gather lookup: the culled
    search on the path's sorted pack against the brute-force kernel on the
    same photons in their original order, on every query (found and best
    d2 equal, values rtol 1e-5), each kernel against its plain version on
    the first PLAIN_QUERIES queries."""
    caustic = next(a for name, a in step_calls if name == "density_auto")
    nearest = next(a for name, a in step_calls if name == "nearest_flash")
    radiance = next(a for name, a in pre_calls if name == "density_auto")
    diffuse_photons, caustic_photons = (
        a for name, a in pre_calls if name == "make_photon_pack_auto")
    photons = next(a for name, a in pre_calls
                   if name == "make_photon_pack_lookup")
    out = {what: check_density(what, args, raw) for what, args, raw in (
        ("caustic", caustic, caustic_photons),
        ("radiance", radiance, diffuse_photons))}

    nr = check_nearest(nearest, photons)
    c, rd = out["caustic"], out["radiance"]
    return [
        dict(name="density_flash", route="cuda",
             source=SRC.format("photon_flash"), replaces=FLASH.format(104),
             max_abs_err=max(c["err"], rd["err"]), ms=c["ms"],
             plain_ms=c["plain_ms"], ms_before=c["ms_before"],
             bound_ms_before=c["bound_before"]["bound_ms"],
             ms_radiance=rd["ms"], plain_ms_radiance=rd["plain_ms"],
             ms_before_radiance=rd["ms_before"],
             bound_ms_radiance=rd["bound"]["bound_ms"],
             bound_ms_before_radiance=rd["bound_before"]["bound_ms"],
             **c["regs"], **c["bound"]),
        dict(name="nearest_flash", route="cuda",
             source=SRC.format("photon_flash"), replaces=FLASH.format(123),
             max_abs_err=nr["err"], ms=nr["ms"], plain_ms=nr["plain_ms"],
             plain_queries=nr["plain_queries"],
             ms_on_plain_queries=nr["ms_on_plain_queries"],
             ms_brute=nr["ms_brute"],
             bound_ms_brute=nr["bound_brute"]["bound_ms"],
             pair_tests_brute=nr["pair_tests_brute"], **nr["bound"]),
    ]


def density_off(a: tuple, b: tuple) -> tuple:
    """Two densities' (flux, count): the queries whose counts differ or
    whose flux is beyond rtol 1e-5 / atol 1e-6 of b's flux scale, and the
    flux's max abs error."""
    (af, ac), (bf, bc) = a, b
    far = ~torch.isclose(af, bf, rtol=1e-5, atol=1e-6 * float(
        bf.abs().max())).all(dim=1)
    return int(((ac != bc) | far).sum()), float((af - bf).abs().max())


def check_culled_kernel(what: str, args, nearest: bool) -> dict:
    """density_culled on one of the scale route's culled gathers (`args`: the
    diffuse pack and the queries): counts equal to density_culled_plain's and
    density_flash_plain's (flash view) on a strided sample of
    PLAIN_CULLED_QUERIES queries, to the flash kernel's over the same sorted
    photons and the body it replaced (`_density_culled_before`) on all of them,
    flux within rtol 1e-5 of each, and two calls bit for bit; counts equal to
    density_flash's warp-per-query search over the same pack (its lanes keep
    one running sum each over a whole query, which over thousands of photons
    drifts past rtol 1e-5: its flux error is reported, not held); ms, ms_before
    (the old body).  The bound counts the pairs of the clusters within each
    query's radius and the box tests the kernel's lists make (a tile's box
    against every word of 32 clusters' union box, against each cluster of the
    near words, and each candidate against the tile's queries:
    `culled_tile_lists`); bound_ms_before the old body's count (every query
    against every cluster box).  With `nearest`, the culled nearest search over
    the same pack (thousands of clusters) against the brute-force kernel in
    best d2."""
    pack, qp, qn, r = args
    nq, n_cl = qp.shape[0], pack["cl_lo"].shape[0]
    sample = slice(None, None, max(1, nq // PLAIN_CULLED_QUERIES))
    (kf, kc), differ, err, plain_ms = compare_density(
        "density_culled", pf.density_culled, pf.density_culled_plain,
        pack, qp, qn, r, sample)
    compare_density("density_culled vs flash plain", pf.density_culled,
                    lambda p, *a: pf.density_flash_plain(pf.flash_view(p),
                                                         *a),
                    pack, qp, qn, r, sample)
    flat = pf.flash_view(pack)
    others = {}
    for key, fn in (("flash_kernel", lambda: pf.density_flash(flat, qp, qn,
                                                                r)),
                    ("warp_search", lambda: pf.density_flash(pack, qp, qn,
                                                              r)),
                    ("old_body", lambda: pf._density_culled_before(
                        pack, qp, qn, r))):
        got, ms_once = once_ms(fn)
        n_off, e = density_off(got, (kf, kc))
        if key == "warp_search":  # counts only: see the docstring
            n_off = int((got[1] != kc).sum())
        others[key] = (n_off, e, ms_once)
    again = pf.density_culled(pack, qp, qn, r)
    repeat = int(((again[0] != kf).any(dim=1) | (again[1] != kc)).sum())
    if repeat or any(v[0] for v in others.values()):
        raise AssertionError(f"density_culled ({what}): {repeat} queries "
                             "differ from a second call; against the others "
                             f"(queries, max abs err, ms): {others}")
    extra = {}
    if nearest:
        # the nearest search over the same pack: thousands of clusters, many
        # sweeps of 256; its best d2 equals the brute force's
        _, nbest = pf.nearest_flash_best(pack, qp, r)
        _, fbest = pf.nearest_flash_best(flat, qp, r)
        extra = dict(nearest_found=int(torch.isfinite(nbest).sum()),
                     nearest_differ_vs_brute=int((nbest != fbest).sum()))
        if extra["nearest_differ_vs_brute"]:
            raise AssertionError("nearest_flash: best d2 over the culled "
                                 "pack differs from the brute-force kernel's")
    kernel = lambda: pf.density_culled(pack, qp, qn, r)  # noqa: E731
    ms = device_ms(kernel, calls=3, replays=3)
    ms_before = device_ms(lambda: pf._density_culled_before(pack, qp, qn, r),
                          calls=2, replays=3)
    pairs, _ = pf.culled_pair_tests(pack, qp, r)
    words, cand, listed = pf.culled_tile_lists(pack, qp, r)
    tiles = cand.shape[0]
    box_tests = (words.numel() + 32 * int(words.sum())
                 + int(cand.sum()) * pf.CULL_QUERIES)
    moved = nbytes(pack["tbl"][0:9], pack["cl_lo"], pack["cl_hi"], qp,
                   qn) + 4 * nq + 16 * nq
    bnd = bound(DENSITY_OPS * pairs + BOX_D2_OPS * box_tests, moved,
                pair_tests=pairs, box_tests=box_tests)
    before = bound(DENSITY_OPS * pairs + BOX_D2_OPS * nq * n_cl, moved)
    per_tile = {f"{k}_per_tile": dict(
        mean=round(float(v.sum(1).float().mean()), 2), max=int(v.sum(1).max()))
        for k, v in (("near_words", words), ("candidates", cand),
                     ("listed", listed))}
    regs = registers("photon_flash", "density_culled_kernel")
    phase("kernel", name="density_culled", gather=what, queries=nq,
          photons=int(pack["n_valid"]), pack=pack["tbl"].shape[1],
          clusters=n_cl, radius=r, compared_queries=kc[sample].shape[0],
          counted=int(kc.sum()), differ=differ, max_abs_err=err,
          repeat_differ=repeat,
          **{f"differ_vs_{k}": v[0] for k, v in others.items()},
          **{f"max_abs_err_vs_{k}": v[1] for k, v in others.items()},
          **{f"{k}_ms_once": round(v[2], 4) for k, v in others.items()},
          tolerance="counts equal; flux rtol 1e-5, atol 1e-6*scale",
          ms=round(ms, 4), ms_before=round(ms_before, 4),
          call_ms=round(call_ms(kernel, 3), 4), plain_ms=round(plain_ms, 4),
          plain=f"density_culled_plain, one eager call on every "
                f"{sample.step}th query", tiles=tiles, **per_tile, **regs,
          registers_before=registers(
              "photon_flash", "density_culled_before_kernel")["registers"],
          bound_ms_before=before["bound_ms"], box_tests_before=nq * n_cl,
          **extra, **bnd)
    return dict(ms=ms, ms_before=ms_before, plain_ms=plain_ms, err=err,
                plain_queries=kc[sample].shape[0], bound=bnd,
                bound_before=before, regs=regs, per_tile=per_tile)


def photon_launch_counts(cfg, maps_info, pair=TINY, n_nee: int = 1) -> dict:
    """Launches a timed photon render makes (its warm-up step included):
    per step fg_samples nearest lookups, one caustic density, raydepth + 1
    + fg_samples closest hits and one NEE shadow batch per light (n_nee
    lights that cast shadows); at preprocess one density per 65,536
    radiance queries and one closest hit per bounce slot of every photon
    pass.  pair: the scene's (closest hit, shadow sum) kernels."""
    steps = cfg.aa_samples + 1
    passes = sum(maps_info[m]["passes"] for m in ("diffuse", "caustic"))
    return {"density_flash": steps + -(-maps_info["radiance"]["queries"]
                                       // photonmap.RADIANCE_QUERIES),
            "nearest_flash": steps * cfg.fg_samples,
            pair[0]: steps * (cfg.raydepth + 1 + cfg.fg_samples)
            + passes * (cfg.photon_bounces + 1),
            pair[1]: steps * n_nee}


def photon_path(smi) -> dict:
    """cornell_photon.xml at its own settings through the entry point."""
    scene = parse_xml_file(PHOTON)
    cfg = build_config(scene)
    res, launches = counted(
        lambda: render_scene(scene, device="cuda", timed=True))
    info = res.stats["photon_maps"]
    img = res.image
    phase("photon_maps", preprocess_s=round(res.stats["preprocess_s"], 4),
          **{m: info[m] for m in ("diffuse", "caustic", "radiance")})
    want = photon_launch_counts(cfg, info)
    phase("photon_path", size=f"{cfg.width}x{cfg.height}",
          spp=cfg.aa_samples, raydepth=cfg.raydepth,
          photons=cfg.photons, caustic_photons=cfg.caustic_photons,
          fg_samples=cfg.fg_samples,
          render_s=round(res.stats["render_s"], 4),
          preprocess_s=round(res.stats["preprocess_s"], 4),
          rays=res.stats["rays"], mrays_per_s=round(res.mrays_per_sec, 3),
          launches=launches, expected_launches=want,
          image_mean=float(img.mean()), gpu=repr(smi))
    if not np.all(np.isfinite(img)) or img.min() < 0.0 or img.mean() <= 0:
        raise AssertionError("photon_path: image is not finite, >= 0, lit")
    for k, v in want.items():
        if launches[k] != v:
            raise AssertionError(f"photon_path: {k} launched {launches[k]} "
                                 f"times, expected {v}")
    return res, launches


def photon_golden() -> None:
    """cornell.xml with the golden's photonmapping overrides
    against the stored golden."""
    golden = read_exr(PHOTON_GOLDEN)
    gs = golden.shape[0]
    cs, cc = photon_scene(CORNELL, "cuda", size=gs, **GOLDEN_PHOTON)
    img = photonmap.render_photonmap(cs, cc, device="cuda").image
    rmse = float(np.sqrt(np.mean((img - golden) ** 2)))
    phase("photon_golden", size=f"{gs}x{gs}", spp=cc.aa_samples,
          photons=cc.photons, caustic_photons=cc.caustic_photons,
          fg_samples=cc.fg_samples, raydepth=cc.raydepth, rmse=rmse,
          bound=0.02)
    if not rmse < 0.02:
        raise AssertionError(f"photon golden RMSE {rmse} >= 0.02")


def photon_card_vs_cpu():
    """The same photon render on the card (kernels) and the CPU (plain
    versions): image RMSE <= 1e-3, stored photons and rays within 0.1%."""
    card = photon_scene(PHOTON, "cuda", **CARD_VS_CPU_PHOTON)
    (cpu,) = yield [(photonmap.render_photonmap,
                     photon_scene(PHOTON, "cpu", **CARD_VS_CPU_PHOTON),
                     dict(device="cpu"))]
    out = dict(cpu=cpu, cuda=photonmap.render_photonmap(*card,
                                                        device="cuda"))
    rmse = float(np.sqrt(np.mean((out["cuda"].image
                                  - out["cpu"].image) ** 2)))
    rel = {}
    for what, get in (
            ("rays", lambda r: r.stats["rays"]),
            ("stored_diffuse",
             lambda r: r.stats["photon_maps"]["diffuse"]["stored"]),
            ("stored_caustic",
             lambda r: r.stats["photon_maps"]["caustic"]["stored"])):
        a, b = get(out["cuda"]), get(out["cpu"])
        rel[what] = (a, b, abs(a - b) / max(b, 1.0))
    phase("photon_card_vs_cpu", **CARD_VS_CPU_PHOTON, rmse=rmse, bound=1e-3,
          **{k: f"{a}/{b} rel={r}" for k, (a, b, r) in rel.items()},
          rel_bound=1e-3)
    if not (rmse <= 1e-3 and all(r <= 1e-3 for _, _, r in rel.values())):
        raise AssertionError("photon_card_vs_cpu: card and CPU disagree")


def photon_scale(cs, cc, smi) -> int:
    """The scale route: 2,000,000 diffuse photons store over
    CULL_MIN_PHOTONS, so the diffuse pack takes the culled layout:
    density_culled runs the radiance-map precompute (with final gather)
    or every sample step's density (without).  The image is held against
    the same render with the diffuse and caustic packs forced onto the
    flash layout (the brute-force kernel).  Returns density_culled's
    launches."""
    tag = "photon_scale" if cc.final_gather else "photon_scale_no_fg"
    res, launches = counted(
        lambda: photonmap.render_photonmap(cs, cc, device="cuda"))
    info = res.stats["photon_maps"]["diffuse"]
    cull_min = pf.CULL_MIN_PHOTONS
    photonmap.make_photon_pack_auto = pf.make_photon_pack
    try:
        flash = photonmap.render_photonmap(cs, cc, device="cuda")
    finally:
        photonmap.make_photon_pack_auto = pf.make_photon_pack_auto
    if {flash.stats["photon_maps"][m]["layout"]
            for m in ("diffuse", "caustic")} != {"flash"}:
        raise AssertionError(f"{tag}: the forced render is not flash")
    rmse = float(np.sqrt(np.mean((res.image - flash.image) ** 2)))
    # with final gather one launch per 65,536 radiance queries, without one
    # every step
    want = (-(-res.stats["photon_maps"]["radiance"]["queries"]
              // photonmap.RADIANCE_QUERIES) if cc.final_gather
            else cc.aa_samples)
    phase(tag, size=f"{cc.width}x{cc.height}", spp=cc.aa_samples,
          photons=cc.photons, final_gather=cc.final_gather, diffuse=info,
          preprocess_s=round(res.stats["preprocess_s"], 4),
          render_s=round(res.stats["render_s"], 4),
          flash_preprocess_s=round(flash.stats["preprocess_s"], 4),
          flash_render_s=round(flash.stats["render_s"], 4),
          launches=launches, expected_density_culled=want,
          image_mean=float(res.image.mean()), rmse_vs_flash=rmse,
          bound=1e-5, gpu=repr(smi))
    if info["layout"] != "culled" or info["stored"] < cull_min:
        raise AssertionError(f"{tag}: the diffuse pack is not culled")
    if launches["density_culled"] != want:
        raise AssertionError(f"{tag}: density_culled launched "
                             f"{launches['density_culled']} times, not {want}")
    if not (np.all(np.isfinite(res.image)) and res.image.mean() > 0):
        raise AssertionError(f"{tag}: image is not finite and lit")
    if not rmse <= 1e-5:
        raise AssertionError(f"{tag}: RMSE vs flash {rmse} > 1e-5")
    return launches["density_culled"]


def culled_gather(calls) -> tuple:
    """The arguments of the first recorded density_auto call over a culled
    pack."""
    return next(a for name, a in calls if name == "density_auto"
                and pf.pack_layout(a[0]) == "culled")


def photon_phases(smi) -> list:
    """Slice 3: the photon kernels against their plain versions at the
    path's shapes, the full-width path through the entry point, one
    profiled step, the golden, the card against the CPU, and the scale
    route with the culled kernel."""
    t0 = time.perf_counter()
    cs, cfg = photon_scene(PHOTON, "cuda")
    phase("photon_scene", tris=cs.static.n_tris_real,
          spheres=cs.static.n_spheres,
          compile_s=round(time.perf_counter() - t0, 3),
          integrator=cfg.integrator, size=f"{cfg.width}x{cfg.height}",
          spp=cfg.aa_samples, filter=cfg.filter_type)
    step, arrays, pre_calls, step_calls = photon_inputs(cs, cfg)
    kernels = check_photon_kernels(pre_calls, step_calls)
    del pre_calls, step_calls

    res, launches = photon_path(smi)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    profile("photon_profile", res, step, arrays, cfg, PHOTON_TAGS, smi)
    del step, arrays

    defer_card(photon_golden)
    defer(photon_card_vs_cpu())

    # the scale route: density_culled at both of its shapes (the radiance
    # precompute's queries; one 512² step's hit points without final
    # gather, over the same photons), its old body on both, and both renders
    scs, scfg = photon_scene(PHOTON, "cuda", **SCALE)
    _, scalls = gather_calls(lambda: photonmap.install_photon_maps(
        scs, scfg, to_tensors(scs.arrays, "cuda")))
    pre = culled_gather(scalls)
    del scalls
    _, _, _, ncalls = photon_inputs(*photon_scene(
        PHOTON, "cuda", photons=SCALE["photons"], final_gather=False))
    nofg = culled_gather(ncalls)
    del ncalls
    c_pre = check_culled_kernel("radiance precompute", pre, nearest=True)
    c_step = check_culled_kernel("512² step without final gather", nofg,
                                 nearest=False)
    check_old_body("density_culled", [pre, nofg])
    del pre, nofg
    launches = photon_scale(scs, scfg, smi)
    launches_no_fg = photon_scale(*photon_scene(
        PHOTON, "cuda", **SCALE, final_gather=False), smi)
    culled = dict(
        name="density_culled", route="cuda",
        source=SRC.format("photon_flash"), replaces=FLASH.format(330),
        launches=launches + launches_no_fg, launches_fg=launches,
        launches_no_fg=launches_no_fg,
        max_abs_err=max(c_pre["err"], c_step["err"]), ms=c_pre["ms"],
        plain_ms=c_pre["plain_ms"], plain_queries=c_pre["plain_queries"],
        ms_before=c_pre["ms_before"],
        bound_ms_before=c_pre["bound_before"]["bound_ms"],
        ms_step=c_step["ms"], ms_before_step=c_step["ms_before"],
        plain_ms_step=c_step["plain_ms"],
        bound_ms_step=c_step["bound"]["bound_ms"],
        bound_ms_before_step=c_step["bound_before"]["bound_ms"],
        listed_per_tile=c_pre["per_tile"]["listed_per_tile"],
        listed_per_tile_step=c_step["per_tile"]["listed_per_tile"],
        **c_pre["regs"], **c_pre["bound"])
    return kernels + [culled]


# ---- slice 4: mid-size meshes (the dense and streaming kernels) -----------


def step_calls(cscene, cfg, module, names: tuple):
    """One sample step on the card with the wrappers `names` of `module`
    recording their arguments, in call order (per path vertex a closest
    hit, the first on the primary rays, and an NEE shadow batch, the first
    at bounce 0: light samples x pixels).  Returns (step, arrays, {name:
    [args, ...]})."""
    step, arrays = path_step(cscene, cfg)
    dev = engine.resolve_device("cuda")
    flags = torch.ones((cfg.height, cfg.width), dtype=torch.bool, device=dev)
    _, calls = record_calls(module, names, lambda: step(
        arrays, _fresh_film(cfg, dev), flags))
    torch.cuda.synchronize()
    return step, arrays, {n: [a for k, a in calls if k == n] for n in names}


# the redesigned kernels, by name: the module of the wrapper and of the
# private entry (_<name>_before) of the body its walk replaced
REDESIGNED = {"closest_hit_tiny": ci, "closest_hit_dense": cx,
              "closest_hit_stream": cx, "shadow_logsum_dense": cx,
              "shadow_logsum_stream": cx, "shadow_logsum_tiny": ci,
              "density_culled": pf}
# those that take the quarter boxes (box32, their third argument), which the
# bodies they replaced do not
TAKES_BOX32 = ("closest_hit_stream", "shadow_logsum_dense",
               "shadow_logsum_stream")


def old_body(name: str, args: tuple):
    """The body that the walk of `name` (one of REDESIGNED) replaced, as a
    call on a recorded call's arguments (less box32 where `name` takes it).
    Its launches are not counted."""
    before = getattr(REDESIGNED[name], f"_{name}_before")
    old = args[:2] + args[3:] if name in TAKES_BOX32 else args
    return lambda: before(*old)


def check_old_body(name: str, calls: list) -> None:
    """The `old_body` phase: rays of every recorded call of `name` (one of
    REDESIGNED) where any returned tensor differs between the walk and the
    body it replaced, which must be 0: both give the brute force's bits.
    For density_culled, queries whose counts differ or whose flux is
    beyond rtol 1e-5 (`density_off`; the two sum in other orders)."""
    kernel = getattr(REDESIGNED[name], name)
    n = 0
    for args in calls:
        a, b = kernel(*args), old_body(name, args)()
        if name == "density_culled":
            n += density_off(a, b)[0]
        elif isinstance(a, tuple):
            n += differ(a, b)
        else:
            n += int((a != b).any(dim=-1).sum())
    phase("old_body", name=name, batches=len(calls), differ_vs_old_body=n)
    if n:
        raise AssertionError(f"{name}: {n} rays differ from the body it "
                             "replaced")


def check_mid_closest(kind: str, args, rays: str) -> dict:
    """closest_hit_<kind> against its plain version on recorded rays: hit
    and tri equal after the epilogue, t, u, v within rtol 1e-4, and bit for
    bit (t and column), again on a second call; ms_before times the
    one-thread body it replaced on the same rays.  Its bound counts what
    each ray needs on its walk's boxes: the real columns of the boxes
    entered below min(tmax, t) and a test of every real box (the stream
    walk's warp, a lane a quarter box (box32), tests what it needs; the
    dense walk tests each live ray against the 16-column boxes its kernel
    builds, cx.dense_boxes, and lists pairs as the tiny walk does:
    pair_tests_made, the pairs listed (it makes at most these), and
    box_tests_made);
    bound_ms_before the one-thread body's cluster count
    (pair_tests_before)."""
    if kind == "stream":
        pk, c8, box32, org, dirn, tmin, tmax, n_tris = args
    else:
        (pk, c8, org, dirn, tmin, tmax, n_tris), box32 = args, None
    kernel = getattr(cx, f"closest_hit_{kind}")
    plain = getattr(cx, f"closest_{kind}_plain")
    kt, kcol = kernel(*args)
    torch.cuda.synchronize()
    (pt, pcol), plain_ms = once_ms(
        lambda: plain(pk, org, dirn, tmin, tmax, n_tris))
    k_hit = fi.closest_epilogue(pk, org, dirn, kt, kcol, n_tris)
    p_hit = fi.closest_epilogue(pk, org, dirn, pt, pcol, n_tris)
    phit = p_hit[4]
    name = f"closest_hit_{kind}"
    if not torch.equal(k_hit[4], phit) or not torch.equal(k_hit[1][phit],
                                                          p_hit[1][phit]):
        raise AssertionError(f"{name}: hit/tri differ from plain ({rays})")
    for what, i in (("t", 0), ("u", 2), ("v", 3)):
        if not torch.allclose(k_hit[i][phit], p_hit[i][phit], rtol=1e-4):
            raise AssertionError(f"{name}: {what} beyond rtol 1e-4 ({rays})")
    n_diff = differ((kt, kcol), (pt, pcol))
    repeat = differ(kernel(*args), (kt, kcol))
    if n_diff or repeat:
        raise AssertionError(f"{name}: {n_diff} rays differ from plain, "
                             f"{repeat} from a second call ({rays})")
    err = max(float((k_hit[i][phit] - p_hit[i][phit]).abs().max())
              for i in (0, 2, 3))
    call = lambda: kernel(*args)  # noqa: E731
    ms = device_ms(call, calls=20, replays=3)
    before_pairs, before_boxes = cx.cluster_pair_tests(
        pk, c8, org, dirn, tmin, torch.minimum(tmax, kt), n_tris)
    moved = nbytes(pk, c8, box32, org, dirn, tmin, tmax, kt, kcol)
    if kind == "stream":
        made, boxes = cx.cluster_pair_tests(
            pk, box32, org, dirn, tmin, torch.minimum(tmax, kt), n_tris)
        need, walk = made, {}
        kernel_name = "closest_stream_kernel"
    else:
        dboxes = torch.from_numpy(cx.dense_boxes(pk.cpu().numpy(),
                                                 n_tris)).to(pk.device)
        made, made_boxes = cx.closest_walk_pair_tests(
            pk, dboxes, org, dirn, tmin, tmax, n_tris)
        need = cx.cluster_pair_tests(pk, dboxes, org, dirn, tmin,
                                     torch.minimum(tmax, kt), n_tris)[0]
        groups = -(-n_tris // cx.DENSE_GROUP)
        boxes = int((tmin <= tmax).sum()) * groups
        walk = dict(group=cx.DENSE_GROUP, box_tests_made=made_boxes)
        # the instance of the kernel the launch takes: the fewest 32-bit
        # masks that hold the pack's groups
        kernel_name = "closest_dense_kernelILi{}E".format(
            1 if groups <= 32 else 2)
    before = bound(MT_OPS * before_pairs + BOX_OPS * before_boxes, moved)
    bnd = bound(MT_OPS * need + BOX_OPS * boxes, moved, pair_tests=need,
                box_tests=boxes)
    extra = dict(
        repeat_differ=repeat,
        ms_before=device_ms(old_body(name, args), calls=20, replays=3),
        **walk, pair_tests_made=made, bound_ms_before=before["bound_ms"],
        pair_tests_before=before_pairs, box_tests_before=before_boxes,
        **registers("cluster_intersect", kernel_name))
    phase("kernel", name=name, rays=rays, n=org.shape[0], tris=n_tris,
          hits=int(phit.sum()), differ=n_diff, max_abs_err=err,
          tolerance="hit,tri equal; t,u,v rtol 1e-4; t, col equal",
          ms=round(ms, 4), call_ms=round(call_ms(call, calls=20), 4),
          plain_ms=round(plain_ms, 4), plain="one eager call", **extra,
          **bnd)
    return dict(ms=ms, plain_ms=plain_ms, err=err, bound=bnd, extra=extra)


def check_mid_shadow(kind: str, args, rays: str = "bounce-0 NEE") -> dict:
    """shadow_logsum_<kind> (SHADOW_DENSE_RAYS or SHADOW_STREAM_RAYS rays a
    thread over the quarter boxes) against its plain version on recorded
    NEE rays: transmission within atol 2e-3, and bit for bit (the scene's
    filters are binary), and again on a second call; ms_before times the
    one-thread body it replaced.  Its bound counts what each ray needs:
    the real columns of the quarters its segment enters (for the stream
    sum, up to the one after which all three channels are opaque) and a
    test of every real quarter box for each live ray; pair_tests_made
    counts what its walk tests (a dense thread's rays share their
    quarters; a stream ray tests what it needs), and bound_ms_before the
    one-thread body's cluster count (pair_tests_before)."""
    pk, c8, box32, logf, org, dirn, dist, n_tris = args
    kernel = getattr(cx, f"shadow_logsum_{kind}")
    plain = getattr(cx, f"shadow_logsum_{kind}_plain")
    name = f"shadow_logsum_{kind}"
    klg = kernel(*args)
    torch.cuda.synchronize()
    plg, plain_ms = once_ms(lambda: plain(pk, logf, org, dirn, dist, n_tris))
    err = float((torch.exp(klg) - torch.exp(plg)).abs().max())
    if err > 2e-3:
        raise AssertionError(f"{name}: transmission off by {err} > 2e-3 "
                             f"({rays})")
    n_diff = int((klg != plg).any(dim=-1).sum())
    repeat = int((kernel(*args) != klg).any(dim=-1).sum())
    if n_diff or repeat:
        raise AssertionError(f"{name}: {n_diff} rays differ from plain, "
                             f"{repeat} from a second call ({rays})")
    call = lambda: kernel(*args)  # noqa: E731
    ms = device_ms(call, calls=10, replays=3)
    lims = cx.shadow_limits(dist)
    pairs, boxes = cx.cluster_pair_tests(pk, c8, org, dirn, *lims, n_tris)
    if kind == "dense":
        made, q_boxes = cx.group_walk_pair_tests(box32, org, dirn, dist,
                                                 n_tris)
        need = cx.cluster_pair_tests(pk, box32, org, dirn, *lims, n_tris)[0]
    else:
        made, q_boxes = cx.stop_walk_pair_tests(pk, box32, logf, org, dirn,
                                                dist, n_tris)
        need = made
    moved = nbytes(pk, c8, box32, logf, org, dirn, dist, klg)
    before = bound(MT_OPS * pairs + BOX_OPS * boxes, moved)
    bnd = bound(MT_OPS * need + BOX_OPS * q_boxes, moved, pair_tests=need,
                box_tests=q_boxes)
    extra = dict(
        repeat_differ=repeat,
        ms_before=device_ms(old_body(name, args), calls=10, replays=3),
        rays_per_thread=getattr(cx, f"SHADOW_{kind.upper()}_RAYS"),
        pair_tests_made=made,
        bound_ms_before=before["bound_ms"], pair_tests_before=pairs,
        box_tests_before=boxes,
        **registers("cluster_intersect", f"shadow_{kind}_kernel"))
    phase("kernel", name=name, rays=rays, n=org.shape[0], tris=n_tris,
          live=int((dist > 0).sum()),
          opaque=int((klg <= -80.0).all(dim=-1).sum()), differ=n_diff,
          max_abs_err=err, tolerance="transmission atol 2e-3; equal",
          ms=round(ms, 4), call_ms=round(call_ms(call, calls=10), 4),
          plain_ms=round(plain_ms, 4), plain="one eager call", **extra,
          **bnd)
    return dict(ms=ms, plain_ms=plain_ms, err=err, bound=bnd, extra=extra)


def mid_cli(kind: str, path: str, res, smi, out_dir: str = "") -> None:
    """The scene through the port's CLI to an .exr at its own settings (in
    out_dir, default the scene's): the image read back, its --json-stats
    rays equal to the entry point's render's (the CLI's render is untimed,
    the same steps without the warm-up) and its image within RMSE 1e-4 of
    it."""
    out = os.path.join(out_dir or os.path.dirname(path), f"{kind}.exr")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main([path, out, "--json-stats", "-vl", "warning"])
    stats = json.loads([line for line in buf.getvalue().splitlines()
                        if line.startswith("{")][-1])
    img = read_exr(out)
    rmse = float(np.sqrt(np.mean((img - res.image) ** 2)))
    rel = abs(stats["rays"] - res.stats["rays"]) / max(res.stats["rays"], 1)
    phase(f"{kind}_cli", rc=rc, output=os.path.basename(out),
          shape=img.shape, wall_s=round(stats["wall_s"], 4),
          render_s=round(stats["render_s"], 4), rays=stats["rays"],
          mrays_per_s=round(stats["mrays_per_sec"], 3), rays_rel=rel,
          rmse_vs_path=rmse, bound=1e-4, gpu=repr(smi))
    if rc != 0 or stats["output"] != out or img.shape != res.image.shape:
        raise AssertionError(f"{kind}_cli: no image of the path's shape")
    if not (np.all(np.isfinite(img)) and rel <= 1e-4 and rmse <= 1e-4):
        raise AssertionError(f"{kind}_cli: the CLI's render disagrees")


def mid_phases(scenes: str, smi) -> list:
    """Slice 4: each generated mid-size scene, its kernels against their
    plain versions on recorded rays, the path through the entry point at
    the scene's own settings, the CLI, one profiled step, and the card
    against the CPU."""
    kernels = []
    for kind, g in MID:
        t0 = time.perf_counter()
        path = make_grid(scenes, g, 1)
        gen_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        scene = parse_xml_file(path)
        cfg = build_config(scene)
        cs = scene.compile(device="cuda")
        a = cs.arrays
        n = cs.static.n_tris_real
        routes = (isect.route(a["tri_pack10"], a["tri_cluster8"], n),
                  isect.route(a["stri_pack10"], a["stri_cluster8"],
                              cs.static.n_stris_real))
        phase(f"{kind}_scene", tris=n, pack=tuple(a["tri_pack10"].shape),
              clusters=a["tri_cluster8"].shape[1],
              sub_clusters=a["tri_sub8"].shape[1], routes=routes,
              generate_s=round(gen_s, 3),
              parse_compile_s=round(time.perf_counter() - t0, 3),
              integrator=cfg.integrator, bounces=cfg.bounces,
              filter=cfg.filter_type, size=f"{cfg.width}x{cfg.height}",
              spp=cfg.aa_samples)
        if routes != (kind, kind):
            raise AssertionError(f"{kind}_scene: routed {routes}")
        names = (f"closest_hit_{kind}", f"shadow_logsum_{kind}")
        step, arrays, calls = step_calls(cs, cfg, cx, names)
        prim = check_mid_closest(kind, calls[names[0]][0], "primary")
        bounce = check_mid_closest(kind, calls[names[0]][1], "bounce 1")
        shad = check_mid_shadow(kind, calls[names[1]][0])
        shad_b = check_mid_shadow(kind, calls[names[1]][1], "bounce-1 NEE")
        for name in names:
            if name in REDESIGNED:
                check_old_body(name, calls[name])
        del calls

        res, launches = counted(
            lambda: render_scene(scene, device="cuda", timed=True))
        others = {k: v for k, v in launches.items() if k not in names and v}
        if others:
            raise AssertionError(f"{kind}_path: off-path kernels {others}")
        check_path(f"{kind}_path", res, cfg,
                   {k: launches[k] for k in names}, smi)
        mid_cli(kind, path, res, smi)
        profile(f"{kind}_profile", res, step, arrays, cfg,
                (f"closest_{kind}_kernel", f"shadow_{kind}_kernel"), smi)
        del step, arrays
        card_vs_cpu(f"{kind}_card_vs_cpu", lambda dev: grid(
            path, MID_CARD_VS_CPU["size"], MID_CARD_VS_CPU["spp"], dev),
            MID_CARD_VS_CPU["size"], MID_CARD_VS_CPU["spp"])

        src = SRC.format("cluster_intersect")
        line = PALLAS.format(308 if kind == "dense" else 592)
        kernels.append(dict(
            name=names[0], route="cuda", source=src, replaces=line,
            launches=launches[names[0]], max_abs_err=max(prim["err"],
                                                         bounce["err"]),
            **before_keys(prim, bounce), **prim["bound"]))
        kernels.append(dict(
            name=names[1], route="cuda", source=src,
            replaces=PALLAS.format(353 if kind == "dense" else 693),
            launches=launches[names[1]],
            max_abs_err=max(shad["err"], shad_b["err"]),
            **before_keys(shad, shad_b), **shad["bound"]))
    return kernels


# ---- slice 5: the pair-granular route -------------------------------------


def ties_only(pack10, org, dirn, col, other, t) -> bool:
    """Where two closest-hit columns differ, the other column gives the
    same t in the kernels' arithmetic: an exact tie."""
    c10 = pack10[:, other.long()]
    t_o, _, _, ok = ci._mt_test(c10, slice(None), *org.unbind(-1),
                                *dirn.unbind(-1))
    return bool(ok.all()) and torch.equal(t_o, t)


def plain_sample(p: int) -> slice:
    """Every k-th slot, at most PLAIN_SLOTS of them: the slots are sorted by
    cluster, so a stride reaches every cluster where a prefix would not."""
    return slice(None, None, -(-p // PLAIN_SLOTS))


def check_pairs_closest(args) -> dict:
    """pairs_closest against its plain version on recorded slots (the
    grid's bounce-1 rays, round 1): t, col and the hits equal on a strided
    sample of at most PLAIN_SLOTS slots, and two calls equal bit for bit;
    ms_before the one-thread body (no sub-box table) on the same slots,
    whose answers must be the same.  The bound counts, per slot, the
    columns of its cluster's sub-clusters entered below min(tmax, its t);
    pair_tests_no_skip the sub-clusters entered below tmax, what the walk
    would test without its skip; bound_ms_before every real column of each
    slot's cluster, what the one-thread body tests."""
    pk, n_cl, sub8, sray, scl, org, dirn, tmin, tmax, n_tris = args
    p = sray.shape[0]
    kt, kcol = pi.pairs_closest(*args)
    at, acol = pi.pairs_closest(*args)
    thread = lambda: pi.pairs_closest(pk, n_cl, None,  # noqa: E731
                                      *args[3:])
    tt, tcol = thread()
    torch.cuda.synchronize()
    repeat = int(((at != kt) | (acol != kcol)).sum())
    differ_thread = int(((tt != kt) | (tcol != kcol)).sum())
    sel = plain_sample(p)
    (pt, pcol), plain_ms = once_ms(lambda: pi.pairs_closest_plain(
        pk, n_cl, sray[sel], scl[sel], org, dirn, tmin, tmax, n_tris))
    kt_s, kcol_s = kt[sel], kcol[sel]
    m = pt.shape[0]
    hit = torch.isfinite(pt)
    if not (torch.equal(torch.isfinite(kt_s), hit)
            and torch.equal(kt_s, pt) and torch.equal(kcol_s, pcol)):
        raise AssertionError("pairs_closest: t, col or hits differ from "
                             "plain")
    if repeat or differ_thread:
        raise AssertionError(f"pairs_closest: {repeat} slots differ from a "
                             f"second call, {differ_thread} from the "
                             "one-thread body")
    err = float((kt_s[hit] - pt[hit]).abs().max()) if hit.any() else 0.0
    call = lambda: pi.pairs_closest(*args)  # noqa: E731
    ms = device_ms(call, calls=5, replays=3)
    ms_before = device_ms(thread, calls=3, replays=3)
    r = sray.long()
    pairs, boxes = pi.slot_pair_tests(sub8, n_cl, sray, scl, org, dirn,
                                      tmin[r], torch.minimum(tmax[r], kt),
                                      n_tris)
    pairs_ns, _ = pi.slot_pair_tests(sub8, n_cl, sray, scl, org, dirn,
                                     tmin[r], tmax[r], n_tris)
    bnd = bound(MT_OPS * pairs + BOX_OPS * boxes,
                nbytes(pk, sub8, sray, scl, org, dirn, tmin, tmax, kt, kcol),
                pair_tests=pairs, box_tests=boxes, slots=p)
    pairs_b = int(fi.real_columns(pk.shape[1] // n_cl, n_cl, n_tris,
                                  pk.device)[scl.long()].sum())
    bnd_b = bound(MT_OPS * pairs_b,
                  nbytes(pk, sray, scl, org, dirn, tmin, tmax, kt, kcol))
    regs = registers("pairs_intersect", "pairs_closest_kernel")
    phase("kernel", name="pairs_closest", rays="bounce 1, round 1",
          n=org.shape[0], tris=n_tris, clusters=n_cl, compared_slots=m,
          compared_stride=sel.step, hits=int(torch.isfinite(kt).sum()),
          differ=int(((kt_s != pt) | (kcol_s != pcol)).sum()),
          repeat_differ=repeat, differ_vs_thread_body=differ_thread,
          max_abs_err=err, tolerance="t, col, hits equal", ms=round(ms, 4),
          ms_before=round(ms_before, 4),
          call_ms=round(call_ms(call, calls=5), 4),
          plain_ms=round(plain_ms, 4),
          plain=f"one eager call on every {sel.step}th slot ({m})",
          **regs, pair_tests_no_skip=pairs_ns,
          bound_ms_before=bnd_b["bound_ms"], pair_tests_before=pairs_b,
          **bnd)
    return dict(name="pairs_closest", route="cuda",
                source=SRC.format("pairs_intersect"),
                replaces=PALLAS.format(1237), max_abs_err=err, ms=ms,
                plain_ms=plain_ms, plain_slots=m, ms_before=ms_before,
                bound_ms_before=bnd_b["bound_ms"], **regs, **bnd)


def check_pairs_shadow(args) -> dict:
    """pairs_shadow against its plain version on recorded slots (the grid's
    bounce-0 NEE rays): transmission within atol 2e-3 on a strided sample
    of at most PLAIN_SLOTS slots.  The bound counts, per slot, the columns
    of its cluster's sub-clusters the segment enters."""
    pk, n_cl, sub8, logf, sray, scl, org, dirn, dist, n_tris = args
    p = sray.shape[0]
    klg = pi.pairs_shadow(*args)
    torch.cuda.synchronize()
    sel = plain_sample(p)
    plg, plain_ms = once_ms(lambda: pi.pairs_shadow_plain(
        pk, n_cl, logf, sray[sel], scl[sel], org, dirn, dist, n_tris))
    klg_s = klg[sel]
    m = plg.shape[0]
    err = float((torch.exp(klg_s) - torch.exp(plg)).abs().max())
    if err > 2e-3:
        raise AssertionError(f"pairs_shadow: transmission off by {err} > "
                             "2e-3")
    call = lambda: pi.pairs_shadow(*args)  # noqa: E731
    ms = device_ms(call, calls=3, replays=3)
    lo, hi = cx.shadow_limits(dist)
    r = sray.long()
    pairs, boxes = pi.slot_pair_tests(sub8, n_cl, sray, scl, org, dirn,
                                      lo[r], hi[r], n_tris)
    bnd = bound(MT_OPS * pairs + BOX_OPS * boxes,
                nbytes(pk, sub8, logf, sray, scl, org, dirn, dist, klg),
                pair_tests=pairs, box_tests=boxes, slots=p)
    phase("kernel", name="pairs_shadow", rays="bounce-0 NEE",
          n=org.shape[0], tris=n_tris, clusters=n_cl, compared_slots=m,
          compared_stride=sel.step,
          differ=int((klg_s != plg).any(dim=-1).sum()),
          max_abs_err=err, tolerance="transmission atol 2e-3",
          ms=round(ms, 4), call_ms=round(call_ms(call, calls=3), 4),
          plain_ms=round(plain_ms, 4),
          plain=f"one eager call on every {sel.step}th slot ({m})", **bnd)
    return dict(name="pairs_shadow", route="cuda",
                source=SRC.format("pairs_intersect"),
                replaces=PALLAS.format(1283), max_abs_err=err, ms=ms,
                plain_ms=plain_ms, plain_slots=m, **bnd)


def compare_routes(what: str, closest, shadow) -> None:
    """The pair route against the fine route on the same rays (closest
    args of `closest_hit_fine`, shadow args of `shadow_logsum_fine`): t and
    hits equal, columns only on exact ties, transmission within atol 2e-3;
    eager ms per call of each (the pair route reads slot and straggler
    counts from the device, so it is not captured in a graph)."""
    pk, cl, sub, org, dirn, tmin, tmax, n_tris = closest
    ft, fcol = fi.closest_hit_fine(*closest)
    pt, pcol = pi.closest_hit_pairs(*closest)
    flip = torch.isfinite(ft) & (pcol != fcol)
    if not torch.equal(pt, ft) or not ties_only(
            pk, org[flip], dirn[flip], pcol[flip], fcol[flip], ft[flip]):
        raise AssertionError(f"{what}: the pair route's closest hits differ "
                             "from the fine route's")
    c_pairs = call_ms(lambda: pi.closest_hit_pairs(*closest), calls=3)
    c_fine = call_ms(lambda: fi.closest_hit_fine(*closest), calls=3)
    flg = fi.shadow_logsum_fine(*shadow)
    plg = pi.shadow_logsum_pairs(*shadow)
    err = float((torch.exp(plg) - torch.exp(flg)).abs().max())
    if err > 2e-3:
        raise AssertionError(f"{what}: pair route transmission off by {err}")
    s_pairs = call_ms(lambda: pi.shadow_logsum_pairs(*shadow), calls=2)
    s_fine = call_ms(lambda: fi.shadow_logsum_fine(*shadow), calls=2)
    phase("pairs_vs_fine", scene=what, closest_rays=org.shape[0],
          hits=int(torch.isfinite(ft).sum()), col_ties=int(flip.sum()),
          closest_pairs_ms=round(c_pairs, 4), closest_fine_ms=round(c_fine, 4),
          shadow_rays=shadow[4].shape[0], shadow_max_abs_err=err,
          shadow_pairs_ms=round(s_pairs, 4), shadow_fine_ms=round(s_fine, 4))


def fine_bounce(closest, fine_kernel: dict) -> None:
    """closest_hit_fine on the grid's recorded bounce-1 rays, where a
    warp's rays share no boxes and the walk order matters: t and col equal
    to the plain brute force on a strided sample, its ms and its bound
    there, added to its kernel entry."""
    pk, cl, sub, org, dirn, tmin, tmax, n_tris = closest
    kt, kcol = fi.closest_hit_fine(*closest)
    torch.cuda.synchronize()
    step = PLAIN_GRID_STRIDE["closest"]
    sample = tuple(x[::step].contiguous() for x in (org, dirn, tmin, tmax))
    (pt, pcol), plain_ms = once_ms(
        lambda: fi.closest_fine_plain(pk, *sample, n_tris))
    differ = int(((kt[::step] != pt) | (kcol[::step] != pcol)).sum())
    if differ:
        raise AssertionError(f"closest_hit_fine: {differ} bounce-1 rays "
                             "differ from plain in t or col")
    ms = device_ms(lambda: fi.closest_hit_fine(*closest), calls=3, replays=3)
    pairs, boxes = fi.fine_pair_tests(cl, sub, org, dirn, tmin,
                                      torch.minimum(tmax, kt), n_tris)
    bnd = bound(MT_OPS * pairs + BOX_OPS * boxes,
                nbytes(pk, cl, sub, org, dirn, tmin, tmax) + 8 * org.shape[0],
                pair_tests=pairs, box_tests=boxes,
                **walk_bracket(cl, sub, org, dirn, tmin, tmax, n_tris))
    phase("kernel", name="closest_hit_fine", rays="bounce 1",
          n=org.shape[0], hits=int(torch.isfinite(kt).sum()),
          compared_rays=pt.shape[0], differ=differ,
          tolerance="t, col equal", ms=round(ms, 4),
          plain_ms=round(plain_ms, 4),
          plain=f"one eager call on every {step}th ray", **bnd)
    fine_kernel.update(ms_bounce=ms, bound_ms_bounce=bnd["bound_ms"],
                       pair_tests_bounce=pairs, box_tests_bounce=boxes)


def fine_bounce_shadow(shadow, fine_kernel: dict) -> None:
    """shadow_logsum_fine on the grid's recorded bounce-1 NEE rays (one
    light sample a pixel, from scattered bounce points: a block's rays
    share few tiles): transmission within atol 2e-3 of the plain brute
    force on a strided sample, its ms and its bound there, added to its
    kernel entry."""
    pk, cl, sub, logf, org, dirn, dist, n_tris = shadow
    lg = fi.shadow_logsum_fine(*shadow)
    torch.cuda.synchronize()
    step = PLAIN_GRID_STRIDE["closest"]
    plg, plain_ms = once_ms(lambda: fi.shadow_logsum_fine_plain(
        pk, logf, *(x[::step].contiguous() for x in (org, dirn, dist)),
        n_tris))
    err = float((torch.exp(lg[::step]) - torch.exp(plg)).abs().max())
    if err > 2e-3:
        raise AssertionError(f"shadow_logsum_fine: bounce-1 transmission off "
                             f"by {err} > 2e-3")
    ms = device_ms(lambda: fi.shadow_logsum_fine(*shadow), calls=3,
                   replays=3)
    pairs, boxes = fi.fine_pair_tests(cl, sub, org, dirn,
                                      *cx.shadow_limits(dist), n_tris)
    bnd = bound(MT_OPS * pairs + BOX_OPS * boxes,
                nbytes(pk, cl, sub, logf, org, dirn, dist, lg),
                pair_tests=pairs, box_tests=boxes)
    phase("kernel", name="shadow_logsum_fine", rays="bounce-1 NEE",
          n=org.shape[0], live=int((dist > 0).sum()),
          compared_rays=plg.shape[0],
          differ=int((lg[::step] != plg).any(dim=-1).sum()),
          max_abs_err=err, tolerance="transmission atol 2e-3",
          ms=round(ms, 4), plain_ms=round(plain_ms, 4),
          plain=f"one eager call on every {step}th ray", **bnd)
    fine_kernel.update(ms_bounce=ms, bound_ms_bounce=bnd["bound_ms"],
                       pair_tests_bounce=pairs, box_tests_bounce=boxes,
                       max_abs_err_bounce=err)


def pairs_path(path: str, gcfg, fine_res, fine_prof, step, arrays, smi):
    """The grid at GRID's settings through render_scene(pairs=True), held to
    slice 2's fine-route render: rays within 0.01%, image RMSE <= 1e-4.
    The pair kernels and nearest_clusters launch, nearest_clusters once
    for each closest-hit and each shadow pass (8 a step, the warm-up step
    counted), the fine kernels only for stragglers, no other kernel.  One
    step profiled (`pairs_profile`); the line sets its step wall, device
    busy ms and launches beside the fine route's (`fine_prof`, the
    `grid_profile` line)."""
    scene = parse_xml_file(path)
    scene.render_params.update(width=GRID["size"], height=GRID["size"],
                               AA_minsamples=GRID["spp"], AA_passes=1)
    cfg = build_config(scene)
    if cfg != gcfg:
        raise AssertionError("pairs_path: not the grid path's config")
    res, launches = counted(lambda: render_scene(
        scene, device="cuda", timed=True, pairs=True))
    names = ("pairs_closest", "pairs_shadow", "nearest_clusters",
             "closest_hit_fine", "shadow_logsum_fine")
    others = {k: v for k, v in launches.items() if k not in names and v}
    rmse = float(np.sqrt(np.mean((res.image - fine_res.image) ** 2)))
    r_p, r_f = res.stats["rays"], fine_res.stats["rays"]
    rel = abs(r_p - r_f) / max(r_f, 1.0)
    steps = cfg.aa_samples + 1
    want_entries = 2 * (cfg.bounces + 1) * steps
    prof = profile("pairs_profile", res, step, arrays, gcfg, PAIR_KERNELS,
                   smi, stages=PAIR_STAGES)
    phase("pairs_path", size=f"{cfg.width}x{cfg.height}", spp=cfg.aa_samples,
          bounces=cfg.bounces, render_s=round(res.stats["render_s"], 4),
          rays=r_p, mrays_per_s=round(res.mrays_per_sec, 3),
          fine_mrays_per_s=round(fine_res.mrays_per_sec, 3),
          step_ms=prof["step_ms"], fine_step_ms=fine_prof["step_ms"],
          device_busy_ms=prof["device_busy_ms"],
          fine_device_busy_ms=fine_prof["device_busy_ms"],
          kernel_launches_per_step=prof.get("kernel_launches"),
          fine_kernel_launches_per_step=fine_prof.get("kernel_launches"),
          launches={k: launches[k] for k in names},
          launches_per_step={k: launches[k] / steps for k in names},
          expected_nearest_clusters=want_entries,
          rmse_vs_fine=rmse, rays_rel=rel, bound=1e-4, gpu=repr(smi))
    if others:
        raise AssertionError(f"pairs_path: off-path kernels {others}")
    if not (launches["pairs_closest"] and launches["pairs_shadow"]):
        raise AssertionError("pairs_path: a pair kernel never launched")
    if launches["nearest_clusters"] != want_entries:
        raise AssertionError(f"pairs_path: nearest_clusters launched "
                             f"{launches['nearest_clusters']} times, "
                             f"expected {want_entries}")
    if not np.all(np.isfinite(res.image)) or res.image.min() < 0.0:
        raise AssertionError("pairs_path: image is not finite and >= 0")
    if not (rmse <= 1e-4 and rel <= 1e-4):
        raise AssertionError("pairs_path: the pair route's render differs "
                             "from the fine route's")
    return res, launches


def check_nearest_clusters(args, rays: str, memory: bool = False) -> dict:
    """nearest_clusters against its plain version on recorded arguments
    (cluster8, sub8, org, dirn, lo, hi, n_tris, k): entries bit for bit,
    ids and counts equal, and a second call the same; kernel ms (a CUDA
    graph of calls), the plain version's one eager call, and the call's
    peak device memory above what was allocated before it (with `memory`
    held to 1.1 x its outputs' bytes plus the box tables: it writes no
    (rays, boxes) table).  The bound counts the box tests its walk needs
    (every real cluster box, and the real sub-boxes of each entered
    cluster); bound_ms_before a test of every real box of the plain
    version's table."""
    cl8, sub8, org, dirn, lo, hi, n_tris, k = args
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ke, kid, kc = pi.nearest_clusters(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    out_bytes = nbytes(ke, kid, kc)
    ae, aid, ac = pi.nearest_clusters(*args)
    (pe, pid, pc), plain_ms = once_ms(
        lambda: pi.nearest_clusters_plain(*args))
    bits = lambda x: x.view(torch.int32)  # noqa: E731
    differ = int(((bits(ke) != bits(pe)) | (kid != pid)).any(dim=1).sum()
                 + (kc != pc).sum())
    repeat = int(((bits(ke) != bits(ae)) | (kid != aid)).any(dim=1).sum()
                 + (kc != ac).sum())
    fin = torch.isfinite(pe)
    err = float((ke[fin] - pe[fin]).abs().max()) if fin.any() else 0.0
    call = lambda: pi.nearest_clusters(*args)  # noqa: E731
    ms = device_ms(call, calls=3, replays=3)
    tests, tests_before = pi.entry_box_tests(cl8, sub8, org, dirn, lo, hi,
                                             n_tris)
    moved = nbytes(cl8, sub8, org, dirn, lo, hi) + out_bytes
    bnd = bound(BOX_OPS * tests, moved, box_tests=tests)
    bnd_b = bound(BOX_OPS * tests_before, moved)
    limit = 1.1 * out_bytes + nbytes(cl8, sub8)
    regs = registers("pair_entries", "nearest_clusters_kernel")
    n_cl, n_sc = cl8.shape[1], sub8.shape[1]
    phase("kernel", name="nearest_clusters", rays=rays, n=org.shape[0], k=k,
          tris=n_tris, clusters=n_cl, sub_boxes=n_sc,
          n_sub=pi.pick_nsub(n_sc * fi.SUB_BT, n_sc * fi.SUB_BT // n_cl),
          entered_mean=round(float(pc.float().mean()), 3),
          entered_max=int(pc.max()), rows_past_k=int((pc > k).sum()),
          rows_tied_at_lo=int(((pe == lo[:, None]).sum(dim=1) >= 2).sum()),
          differ=differ, repeat_differ=repeat, max_abs_err=err,
          tolerance="entries bit-equal, ids and counts equal",
          ms=round(ms, 4), call_ms=round(call_ms(call, calls=3), 4),
          plain_ms=round(plain_ms, 4), plain="one eager call, every ray",
          peak_bytes=peak, out_bytes=out_bytes, peak_limit_bytes=int(limit),
          **regs, box_tests_before=tests_before,
          bound_ms_before=bnd_b["bound_ms"], **bnd)
    if differ or repeat:
        raise AssertionError(f"nearest_clusters ({rays}): {differ} rays "
                             f"differ from plain, {repeat} from a second "
                             "call")
    if memory and peak > limit:
        raise AssertionError(f"nearest_clusters ({rays}): peak {peak} B "
                             f"above its inputs, limit {int(limit)} B")
    return dict(name="nearest_clusters", route="cuda",
                source=SRC.format("pair_entries"),
                replaces=PALLAS.format(1173), max_abs_err=err, ms=ms,
                plain_ms=plain_ms, peak_bytes=peak, out_bytes=out_bytes,
                bound_ms_before=bnd_b["bound_ms"], **regs, **bnd)


def soup131(smi) -> None:
    """The 131,072-triangle random soup (BT 1,024, 128 clusters) with
    262,144 incoherent and coherent rays (`scene/generate.py` make_soup /
    make_rays, the benchmarks' bench_pairs rays and filters), the pair and
    the fine route for
    closest hits and shadows, each against the plain brute force on the
    first 16,384 rays; eager ms per call of each route; and each shadow
    kernel called twice on the same rays or slots, bit-equal."""
    v0, e1, e2 = make_soup(SOUP["tris"])
    n_tris = v0.shape[0]
    pack, cl8, s_ord = ci.build_tri_pack(v0, e1, e2,
                                         ci.morton_order(v0, e1, e2))
    rng = np.random.default_rng(9)
    filt = (rng.random((n_tris, 3))
            * (rng.random((n_tris, 1)) > 0.5)).astype(np.float32)
    tp = pack.shape[1]
    fcols = np.where((np.arange(tp) < n_tris)[None, :], filt[s_ord].T, 1.0)
    dev = "cuda"
    pk = torch.from_numpy(pack).to(dev)
    cl = torch.from_numpy(cl8).to(dev)
    sub = torch.from_numpy(fi.sub_aabbs(pack, n_tris)).to(dev)
    logf = ci.log_filter(torch.from_numpy(
        np.ascontiguousarray(fcols, np.float32)).to(dev))
    n = SOUP["rays"]
    m = PLAIN_QUERIES
    for kind in ("incoherent", "coherent"):
        o, d = (torch.from_numpy(x).to(dev) for x in make_rays(n, kind))
        tmin = torch.full((n,), 1e-3, device=dev)
        tmax = torch.full((n,), 1e9, device=dev)
        dist = torch.from_numpy(rng.uniform(0.3, 1.5, n).astype(np.float32)
                                * 10.0).to(dev)
        closest = (pk, cl, sub, o, d, tmin, tmax, n_tris)
        shadow = (pk, cl, sub, logf, o, d, dist, n_tris)
        bt, bcol = fi.closest_fine_plain(pk, o[:m], d[:m], tmin[:m],
                                         tmax[:m], n_tris)
        blg = fi.shadow_logsum_fine_plain(pk, logf, o[:m], d[:m], dist[:m],
                                          n_tris)
        out = {}
        for route, c_fn, s_fn in (
                ("pairs", pi.closest_hit_pairs, pi.shadow_logsum_pairs),
                ("fine", fi.closest_hit_fine, fi.shadow_logsum_fine)):
            t, col = c_fn(*closest)
            flip = torch.isfinite(bt) & (col[:m] != bcol)
            if not torch.equal(t[:m], bt) or not ties_only(
                    pk, o[:m][flip], d[:m][flip], col[:m][flip], bcol[flip],
                    bt[flip]):
                raise AssertionError(f"soup131 {kind}: {route} closest hits "
                                     "differ from the brute force")
            err = float((torch.exp(s_fn(*shadow)[:m])
                         - torch.exp(blg)).abs().max())
            if err > 2e-3:
                raise AssertionError(f"soup131 {kind}: {route} shadows off "
                                     f"by {err}")
            out[route] = dict(
                col_ties=int(flip.sum()), shadow_err=err,
                closest_ms=round(call_ms(lambda: c_fn(*closest), 2), 4),
                shadow_ms=round(call_ms(lambda: s_fn(*shadow), 2), 4))
        # the soup's filters are not binary, so the order of a sum shows in
        # its last bits: two calls of a shadow kernel must still agree
        lg1, lg2 = (fi.shadow_logsum_fine(*shadow) for _ in range(2))
        _, rec = record_calls(pi, ("pairs_shadow",),
                              lambda: pi.shadow_logsum_pairs(*shadow))
        sl1, sl2 = (pi.pairs_shadow(*rec[0][1]) for _ in range(2))
        repeat = dict(
            shadow_logsum_fine=int((lg1 != lg2).any(dim=-1).sum()),
            pairs_shadow=int((sl1 != sl2).any(dim=-1).sum()))
        phase("soup131", rays=kind, n=n, tris=n_tris,
              clusters=cl.shape[1], sub_clusters=sub.shape[1],
              compared_rays=m, hits=int(torch.isfinite(bt).sum()),
              pairs=out["pairs"], fine=out["fine"],
              partly_lit=int(((lg1 > -80.0) & (lg1 < 0.0)).any(dim=-1).sum()),
              slots=sl1.shape[0], repeat_differ=repeat,
              closest_speedup=out["fine"]["closest_ms"]
              / out["pairs"]["closest_ms"],
              shadow_speedup=out["fine"]["shadow_ms"]
              / out["pairs"]["shadow_ms"], gpu=repr(smi))
        if any(repeat.values()):
            raise AssertionError(f"soup131 {kind}: two calls of a shadow "
                                 f"kernel differ: {repeat}")


def fine_sweeps() -> dict:
    """closest_hit_fine on a random soup of more than 256 clusters, where
    its walk takes the cluster boxes in more than one sweep: t and col
    equal to the plain brute force on incoherent rays.  nearest_clusters
    on the same pack (too many sub-boxes for the sub-box table: its
    entries take the cluster boxes, in two sweeps of its warp) and rays at
    k 21 and 24, against its plain version; returns the k 24 entry."""
    v0, e1, e2 = make_soup(SWEEPS["tris"])
    n_tris = v0.shape[0]
    pack, cl8, _ = ci.build_tri_pack(v0, e1, e2, ci.morton_order(v0, e1, e2))
    pk, cl, sub = (torch.from_numpy(x).to("cuda") for x in (
        pack, cl8, fi.sub_aabbs(pack, n_tris)))
    n = SWEEPS["rays"]
    o, d = (torch.from_numpy(x).to("cuda")
            for x in make_rays(n, "incoherent"))
    tmin = torch.full((n,), 1e-3, device="cuda")
    tmax = torch.full((n,), 1e9, device="cuda")
    kt, kcol = fi.closest_hit_fine(pk, cl, sub, o, d, tmin, tmax, n_tris)
    pt, pcol = fi.closest_fine_plain(pk, o, d, tmin, tmax, n_tris)
    differ = int(((kt != pt) | (kcol != pcol)).sum())
    phase("fine_sweeps", tris=n_tris, clusters=cl.shape[1], rays=n,
          hits=int(torch.isfinite(pt).sum()), differ=differ,
          tolerance="t, col equal")
    if cl.shape[1] <= 256 or differ:
        raise AssertionError(f"fine_sweeps: {differ} rays differ from plain "
                             f"over {cl.shape[1]} clusters")
    args = (cl, sub, o, d, tmin, tmax, n_tris)
    check_nearest_clusters((*args, 21), "sweeps")
    return check_nearest_clusters((*args, 24), "sweeps")


def pairs_phases(scenes: str, grid_path: str, gscene, gcfg, fine_res,
                 fine_kernels, fine_prof, smi) -> list:
    """Slice 5: the pair kernels against their plain versions on slots
    recorded from a grid step, the fine kernels on bounce-1 rays, the two
    routes on the same recorded rays, the grid path through the pair route,
    one profiled step, the card against the CPU on the 10K grid, the soup,
    and the fine closest hit over a pack of several sweeps.  Slice 25:
    nearest_clusters against its plain version on the step's recorded
    primary rays (k 21) and bounce-0 NEE segments (k 24), and on the
    sweeps pack."""
    _, _, calls = step_calls(gscene, gcfg, fi, ("closest_hit_fine",
                                                "shadow_logsum_fine"))
    fine_bounce(calls["closest_hit_fine"][1], fine_kernels[0])
    fine_bounce_shadow(calls["shadow_logsum_fine"][1], fine_kernels[1])
    compare_routes("grid164k", calls["closest_hit_fine"][1],
                   calls["shadow_logsum_fine"][0])
    del calls

    pscene, _ = grid(grid_path, GRID["size"], GRID["spp"], "cuda",
                     pairs=True)
    step, arrays, calls = step_calls(pscene, gcfg, pi, (
        "pairs_closest", "pairs_shadow", "nearest_clusters"))
    rounds = [a[3].shape[0] for a in calls["pairs_closest"]]
    picks = [(a[2].shape[0], a[7]) for a in calls["nearest_clusters"]]
    phase("pairs_slots", closest_per_round=rounds,
          shadow=[a[4].shape[0] for a in calls["pairs_shadow"]],
          entries_rays_k=picks)
    # a vertex's closest hit, then its NEE batch: primary, bounce-0 NEE
    n_px = gcfg.width * gcfg.height
    if picks[0] != (n_px, 21) or picks[1][1] != 24 or picks[1][0] <= n_px:
        raise AssertionError(f"nearest_clusters: calls {picks[:2]}, "
                             "expected the primary rays at k 21, then the "
                             "bounce-0 NEE segments at k 24")
    entries = check_nearest_clusters(calls["nearest_clusters"][1],
                                     "bounce-0 NEE", memory=True)
    primary = check_nearest_clusters(calls["nearest_clusters"][0],
                                     "primary")
    entries.update({f"{key}_primary": primary[key] for key in (
        "ms", "plain_ms", "bound_ms", "box_tests", "bound_ms_before")})
    kernels = [check_pairs_closest(calls["pairs_closest"][2]),
               check_pairs_shadow(calls["pairs_shadow"][0]), entries]
    del calls

    res, launches = pairs_path(grid_path, gcfg, fine_res, fine_prof, step,
                               arrays, smi)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    del step, arrays

    small = make_grid(scenes, PAIRS_SMALL["grid"], PAIRS_SMALL["subdiv"])
    cs, _ = grid(small, PAIRS_SMALL["size"], PAIRS_SMALL["spp"], "cuda",
                 pairs=True)
    a = cs.arrays
    route = isect.route(a["tri_pack10"], a["tri_cluster8"],
                        cs.static.n_tris_real, cs.static.pairs)
    phase("pairs_small_scene", tris=cs.static.n_tris_real,
          clusters=a["tri_cluster8"].shape[1], route=route)
    if route != "pairs":
        raise AssertionError(f"pairs_small_scene: routed {route}")
    card_vs_cpu("pairs_card_vs_cpu", lambda dev: grid(
        small, PAIRS_SMALL["size"], PAIRS_SMALL["spp"], dev, pairs=True),
        PAIRS_SMALL["size"], PAIRS_SMALL["spp"])

    soup131(smi)
    sweeps = fine_sweeps()
    entries.update({f"{key}_sweeps": sweeps[key] for key in (
        "ms", "plain_ms", "bound_ms", "box_tests")})
    return kernels


def slice25_phases(smi, out_dir: str, kernels: list) -> None:
    """The pair route's phases alone (`pairs_phases`, with slice 25's
    nearest_clusters): the 164K grid written to out_dir and rendered on the
    fine route first, the yardstick of the pair path."""
    path = make_grid(out_dir, GRID["grid"], GRID["subdiv"])
    gscene, gcfg = grid(path, GRID["size"], GRID["spp"], "cuda")
    res, launches = render_counted(gscene, gcfg, ("closest_hit_fine",
                                                  "shadow_logsum_fine"))
    check_path("grid_path", res, gcfg, launches, smi)
    prof = profile("grid_profile", res, *path_step(gscene, gcfg), gcfg,
                   ("fine_kernel",), smi)
    fine = [dict(name="closest_hit_fine"), dict(name="shadow_logsum_fine")]
    kernels += pairs_phases(out_dir, path, gscene, gcfg, res, fine, prof, smi)


# ---- slice 14: directlighting, Beer glass, caustic map, SPPM --------------


def scene_at(path: str, render_params=None, integrator=None):
    """A scene of the repository, parsed, with render and integrator
    parameters set as its XML would set them."""
    scene = parse_xml_file(path)
    scene.render_params.update(render_params or {})
    scene.integrator_params["default"].update(integrator or {})
    return scene


def entry_counted(scene, names: tuple):
    """render_scene(timed=True) on the card, counted; returns the launches
    of `names` and raises if any other kernel launched."""
    res, launches = counted(
        lambda: render_scene(scene, device="cuda", timed=True))
    others = {k: v for k, v in launches.items() if k not in names and v}
    if others:
        raise AssertionError(f"kernels off the path launched: {others}")
    return res, {k: launches[k] for k in names}


def path_line(tag, res, cfg, launches, want, smi, **extra) -> None:
    """A slice-14 path's phase line and its checks: a finite image >= 0,
    lit, and each kernel launched as often as the path's vertices ask."""
    img = res.image
    phase(tag, size=f"{cfg.width}x{cfg.height}", integrator=cfg.integrator,
          **extra, render_s=round(res.stats["render_s"], 4),
          rays=res.stats["rays"], mrays_per_s=round(res.mrays_per_sec, 3),
          launches=launches, expected_launches=want,
          image_mean=float(img.mean()), gpu=repr(smi))
    if not (np.all(np.isfinite(img)) and img.min() >= 0.0
            and img.mean() > 0.0):
        raise AssertionError(f"{tag}: image is not finite, >= 0 and lit")
    if launches != want:
        raise AssertionError(f"{tag}: launches {launches}, expected {want}")


def direct_phases(smi, out_dir: str) -> dict:
    """cornell.xml at its own settings (directlighting, raydepth 3, 512²,
    64 spp) through render_scene and the CLI, one profiled step, and the
    card against the CPU at 64², 4 spp.  Returns the path's launches."""
    scene = scene_at(CORNELL)
    cfg = build_config(scene)
    res, launches = entry_counted(scene, TINY)
    want = dict.fromkeys(TINY, (cfg.raydepth + 1) * (cfg.aa_samples + 1))
    path_line("direct_path", res, cfg, launches, want, smi,
              spp=cfg.aa_samples, raydepth=cfg.raydepth)
    mid_cli("direct", CORNELL, res, smi, out_dir)
    profile("direct_profile", res, *path_step(scene.compile(device="cuda"),
                                              cfg), cfg, ("tiny_kernel",),
            smi)
    card_vs_cpu("direct_card_vs_cpu", lambda dev: photon_scene(
        CORNELL, dev, size=64, aa_samples=4), 64, 4)
    return launches


def glass_phases(smi) -> tuple:
    """cornell_path.xml at its own settings and bench.py config 2's 16 spp
    (512²): the tiny kernels against their plain versions on this path's
    recorded primary rays and bounce-0 NEE rays (their sphere roots merged
    in torch: the segments end at the absorbing glass or pass it), the
    render through render_scene, one profiled step, and the card against
    the CPU at 64², 4 spp.  Returns (launches, closest check, shadow
    check)."""
    scene = scene_at(CORNELL_PATH, dict(AA_minsamples=GLASS_SPP))
    cfg = build_config(scene)
    cs = scene.compile(device="cuda")
    step, arrays, rec = step_calls(cs, cfg, ci, ("closest_hit_tiny",
                                                 "shadow_transmission_tiny"))
    c = rec["closest_hit_tiny"][0]
    closest = check_tiny_closest(c[0], c[1:5], c[5],
                                 rays_name="cornell_path primary")
    sh = rec["shadow_transmission_tiny"][0]
    shadow = check_tiny_shadow(sh[0], ci.log_filter(sh[1]), sh[2:5], sh[5],
                               rays="cornell_path bounce-0 NEE")
    del rec
    res, launches = entry_counted(scene, TINY)
    want = dict.fromkeys(TINY, (cfg.bounces + 1) * (cfg.aa_samples + 1))
    path_line("path_glass", res, cfg, launches, want, smi,
              spp=cfg.aa_samples, bounces=cfg.bounces,
              rr_min_bounces=cfg.rr_min_bounces)
    profile("path_glass_profile", res, step, arrays, cfg, ("tiny_kernel",),
            smi)
    del step, arrays
    card_vs_cpu("path_glass_card_vs_cpu", lambda dev: photon_scene(
        CORNELL_PATH, dev, size=64, aa_samples=4), 64, 4)
    return launches, closest, shadow


def caustic_phases(smi) -> tuple:
    """cornell_path.xml with caustic_type=both, 512², 4 spp: the caustic
    map's gather at the first vertex (`density_flash`'s warp search over
    the map's sorted pack) held to density_flash_plain on every query and
    to the brute force (`check_density`), then the render through
    render_scene.  Returns (launches, the gather's check)."""
    scene = scene_at(CORNELL_PATH, dict(AA_minsamples=CAUSTIC_SPP),
                     dict(caustic_type="both"))
    cfg = build_config(scene)
    cs = scene.compile(device="cuda")
    (dev, arrays, make_step, stats), pre = record_calls(
        photonmap, ("make_photon_pack_auto",),
        lambda: rmod._setup(cs, cfg, "cuda"))
    step = make_step(cfg)
    flags = torch.ones((cfg.height, cfg.width), dtype=torch.bool, device=dev)
    _, calls = record_calls(engine, ("density_auto",), lambda: step(
        arrays, _fresh_film(cfg, dev), flags))
    torch.cuda.synchronize()
    dens = check_density("caustic path", calls[0][1], pre[0][1])
    del arrays, step, calls, pre
    names = TINY + ("density_flash",)
    res, launches = entry_counted(scene, names)
    steps = cfg.aa_samples + 1
    want = dict(closest_hit_tiny=(cfg.bounces + 1) * steps
                + cfg.photon_bounces + 1,
                shadow_logsum_tiny=(cfg.bounces + 1) * steps,
                density_flash=steps)
    path_line("caustic_path", res, cfg, launches, want, smi,
              spp=cfg.aa_samples, caustic_type=cfg.caustic_type,
              caustic_map=res.stats["photon_maps"]["caustic"],
              preprocess_s=round(res.stats["preprocess_s"], 4))
    return launches, dens


def sppm_profile(cs, cfg, smi, render_s: float) -> dict:
    """One SPPM pass (eye pass, photon pass, compaction, pack, gather and
    update) under torch.profiler, after an unprofiled one."""
    dev = engine.resolve_device("cuda")
    fresh, one = sppm.make_sppm_pass(cs, cfg, dev)
    arrays = to_tensors(cs.arrays, dev)
    one(arrays, fresh(), 0)  # the compaction's capacity
    prof = profile_step(lambda a, film, flags: one(a, fresh(), 1)[0]["film"],
                        arrays, cfg, ("tiny_kernel", "density_sorted"))
    pass_ms = 1e3 * render_s / cfg.sppm_passes
    busy = prof["device_busy_ms"]
    phase("sppm_profile", pass_ms=round(pass_ms, 3), **prof,
          busy_share=(busy / pass_ms if isinstance(busy, float)
                      else "not measured"), gpu=repr(smi))
    return prof


def sppm_phases(smi) -> tuple:
    """cornell_sppm.xml at its own settings (512², 16 passes, 200,000
    photons a pass, raydepth 5) through render_scene: every pass's gather
    recorded, the first timed pass's and the last one's held to
    density_flash_plain (the last also to the brute force: `check_density`);
    one profiled pass; the card against the CPU at 32², 2 passes, 16,384
    photons; the golden.  Returns (launches, the last gather's check, the
    first gather's (kernel ms, plain ms, max abs err))."""
    scene = scene_at(CORNELL_SPPM)
    cfg = build_config(scene)
    names = TINY + ("density_flash",)
    (res, launches), calls = record_calls(
        sppm, ("density_auto", "make_photon_pack_auto"),
        lambda: entry_counted(scene, names))
    passes = cfg.sppm_passes + 1  # the warm-up pass
    want = dict(closest_hit_tiny=passes * (cfg.raydepth + cfg.photon_bounces
                                           + 2),
                shadow_logsum_tiny=passes * (cfg.raydepth + 1),
                density_flash=passes)
    ph = res.stats["photons"]
    path_line("sppm_path", res, cfg, launches, want, smi,
              passes=cfg.sppm_passes, raydepth=cfg.raydepth,
              photons=cfg.sppm_photons, lanes=ph["lanes"], cap=ph["cap"],
              stored_per_pass=ph["stored"])
    gathers = [a for k, a in calls if k == "density_auto"]
    packs = [a for k, a in calls if k == "make_photon_pack_auto"]
    if len(gathers) != passes or len(packs) != passes:
        raise AssertionError("sppm_path: not one gather a pass")
    pack, qp, qn, r = gathers[1]
    (_, kc), differ, err, plain_ms = compare_density(
        "density_flash (SPPM first pass)", pf.density_flash,
        lambda p, *a: pf.density_flash_plain(pf.flash_view(p), *a),
        pack, qp, qn, r, slice(None))
    first_ms = device_ms(lambda: pf.density_flash(pack, qp, qn, r), calls=3,
                         replays=3)
    phase("kernel", name="density_flash", gather="SPPM pass 1 of 16",
          queries=qp.shape[0], photons=int(pack["n_valid"]),
          radius=radius_text(r),
          counted=int(kc.sum()), differ=differ, max_abs_err=err,
          tolerance="counts equal; flux rtol 1e-5, atol 1e-6*scale",
          ms=round(first_ms, 4), plain_ms=round(plain_ms, 4))
    last = check_density("SPPM pass 16 of 16", gathers[-1], packs[-1])
    del calls, gathers, packs, pack, qp, qn, r
    sppm_profile(scene.compile(device="cuda"), cfg, smi,
                 res.stats["render_s"])

    defer(sppm_card_vs_cpu())
    defer_card(sppm_golden)
    return launches, last, dict(ms=first_ms, plain_ms=plain_ms, err=err)


def sppm_card_vs_cpu():
    """The same SPPM render on the card and the CPU (CARD_VS_CPU_SPPM):
    image RMSE <= 1e-3, rays within 0.1%."""
    def make(dev):
        return photon_scene(CORNELL_SPPM, dev, size=CARD_VS_CPU_SPPM["size"],
                            **{k: v for k, v in CARD_VS_CPU_SPPM.items()
                               if k != "size"})

    card = make("cuda")
    (cpu,) = yield [(sppm.render_sppm, make("cpu"), dict(device="cpu"))]
    out = dict(cpu=cpu, cuda=sppm.render_sppm(*card, device="cuda"))
    rmse = float(np.sqrt(np.mean((out["cuda"].image
                                  - out["cpu"].image) ** 2)))
    r_gpu, r_cpu = out["cuda"].stats["rays"], out["cpu"].stats["rays"]
    rel = abs(r_gpu - r_cpu) / max(r_cpu, 1.0)
    phase("sppm_card_vs_cpu", **CARD_VS_CPU_SPPM, rmse=rmse, bound=1e-3,
          rays_gpu=r_gpu, rays_cpu=r_cpu, rays_rel=rel, rel_bound=1e-3,
          stored_gpu=out["cuda"].stats["photons"]["stored"],
          stored_cpu=out["cpu"].stats["photons"]["stored"])
    if not (rmse <= 1e-3 and rel <= 1e-3):
        raise AssertionError("sppm_card_vs_cpu: card and CPU disagree")


def sppm_golden() -> None:
    """SPPM on cornell.xml at the golden's overrides (GOLDEN_SPPM) against
    the stored golden: RMSE < 0.02."""
    golden = read_exr(SPPM_GOLDEN)
    gs = golden.shape[0]
    cs, cc = photon_scene(CORNELL, "cuda", size=gs, **GOLDEN_SPPM)
    gres = sppm.render_sppm(cs, cc, device="cuda")
    rmse = float(np.sqrt(np.mean((gres.image - golden) ** 2)))
    phase("sppm_golden", size=f"{gs}x{gs}", passes=cc.sppm_passes,
          photons=cc.sppm_photons, raydepth=cc.raydepth,
          render_s=round(gres.stats["render_s"], 4), rmse=rmse, bound=0.02)
    if not rmse < 0.02:
        raise AssertionError(f"SPPM golden RMSE {rmse} >= 0.02")


def slice14_phases(smi, out_dir: str, kernels: list) -> None:
    """The slice-14 paths; their launches and the new shapes' checks go
    into the `kernels` entries of the tiny kernels and density_flash
    (each entry's `launches` stays its first path's)."""
    by_name = {k["name"]: k for k in kernels}
    direct = direct_phases(smi, out_dir)
    glass, closest, shadow = glass_phases(smi)
    caustic, dens_c = caustic_phases(smi)
    sppm_l, dens_s, first = sppm_phases(smi)
    for name in TINY:
        by_name[name].update({
            "launches_direct": direct[name],
            "launches_path_glass": glass[name],
            "launches_caustic_path": caustic[name],
            "launches_sppm": sppm_l[name]})
    for key, chk in (("closest_hit_tiny", closest),
                     ("shadow_logsum_tiny", shadow)):
        by_name[key].update(ms_path_glass=chk["ms"],
                            plain_ms_path_glass=chk["plain_ms"],
                            bound_ms_path_glass=chk["bound"]["bound_ms"],
                            max_abs_err_path_glass=chk["err"])
    by_name["density_flash"].update(
        launches_caustic_path=caustic["density_flash"],
        launches_sppm=sppm_l["density_flash"],
        ms_caustic_path=dens_c["ms"], plain_ms_caustic_path=dens_c[
            "plain_ms"], bound_ms_caustic_path=dens_c["bound"]["bound_ms"],
        ms_sppm=dens_s["ms"], plain_ms_sppm=dens_s["plain_ms"],
        bound_ms_sppm=dens_s["bound"]["bound_ms"],
        ms_sppm_first=first["ms"], plain_ms_sppm_first=first["plain_ms"],
        max_abs_err_sppm=max(dens_s["err"], first["err"], dens_c["err"]))


# ---- slice 15: IBL and textures --------------------------------------------


def check_assets(cs) -> dict:
    """ibl_spheres.xml's textures hold its two assets, loaded from their
    files: equal to load_image of each (the reference's stand-in for a
    failed load is a 16 x 16 checker).  Returns their shapes."""
    from libyafaray_tpu_torch.io.image import load_image

    shapes = {}
    for key, (path, shape) in IBL_ASSETS.items():
        got = np.asarray(cs.arrays[key])
        if got.shape != shape or not np.array_equal(
                got, load_image(os.path.join(REPO, path))[..., :3]):
            raise AssertionError(f"{key} is not {path} ({got.shape})")
        shapes[key] = f"{os.path.basename(path)}:{shape[0]}x{shape[1]}"
    return shapes


def ibl_phases(smi, out_dir: str) -> tuple:
    """ibl_spheres.xml at its own settings (pathtracing, bounces 5, RR from
    3, 512², 64 spp, IBL light with 8 samples): its assets, the tiny
    kernels against their plain versions on one step's recorded primary
    rays and bounce-0 NEE rays (2,097,152 segments of 1e8 toward the
    environment), the render through render_scene, the CLI at 64², 16
    spp, one profiled step, the card against the CPU at 64², 4 spp, and
    the golden at 96², 48 spp.  Returns (launches, closest check, shadow
    check)."""
    scene = scene_at(IBL)
    cfg = build_config(scene)
    cs = scene.compile(device="cuda")
    assets = check_assets(cs)
    step, arrays, rec = step_calls(cs, cfg, ci, ("closest_hit_tiny",
                                                 "shadow_transmission_tiny"))
    c = rec["closest_hit_tiny"][0]
    closest = check_tiny_closest(c[0], c[1:5], c[5],
                                 rays_name="ibl_spheres primary")
    sh = rec["shadow_transmission_tiny"][0]
    shadow = check_tiny_shadow(sh[0], ci.log_filter(sh[1]), sh[2:5], sh[5],
                               rays="ibl_spheres bounce-0 NEE")
    del rec
    res, launches = entry_counted(scene, TINY)
    want = dict.fromkeys(TINY, (cfg.bounces + 1) * (cfg.aa_samples + 1))
    path_line("ibl_path", res, cfg, launches, want, smi,
              spp=cfg.aa_samples, bounces=cfg.bounces,
              rr_min_bounces=cfg.rr_min_bounces,
              ibl_samples=cs.static.bg.ibl_samples, assets=assets)
    mid_cli("ibl", IBL, res, smi, out_dir)
    profile("ibl_profile", res, step, arrays, cfg, ("tiny_kernel",), smi)
    del step, arrays
    card_vs_cpu("ibl_card_vs_cpu", lambda dev: photon_scene(
        IBL, dev, size=64, aa_samples=4), 64, 4)
    defer_card(ibl_golden)
    return launches, closest, shadow


def ibl_golden() -> None:
    """ibl_spheres.xml at IBL_GOLDEN_SPP against the stored golden: RMSE <
    0.05 (tests/test_golden.py's bound)."""
    golden = read_exr(IBL_GOLDEN)
    gs = golden.shape[0]
    gcs, gcc = photon_scene(IBL, "cuda", size=gs, aa_samples=IBL_GOLDEN_SPP,
                            aa_passes=1)
    gres = render(gcs, gcc, device="cuda")
    rmse = float(np.sqrt(np.mean((gres.image - golden) ** 2)))
    phase("ibl_golden", size=f"{gs}x{gs}", spp=gcc.aa_samples,
          render_s=round(gres.stats["render_s"], 4), rmse=rmse, bound=0.05)
    if not rmse < 0.05:
        raise AssertionError(f"IBL golden RMSE {rmse} >= 0.05")


def slice15_phases(smi, out_dir: str, kernels: list) -> None:
    """The IBL path; its launches and the tiny kernels' checks on its rays
    go into their `kernels` entries (`*_ibl`)."""
    by_name = {k["name"]: k for k in kernels}
    launches, closest, shadow = ibl_phases(smi, out_dir)
    for key, chk in (("closest_hit_tiny", closest),
                     ("shadow_logsum_tiny", shadow)):
        by_name[key].update(launches_ibl=launches[key], ms_ibl=chk["ms"],
                            plain_ms_ibl=chk["plain_ms"],
                            bound_ms_ibl=chk["bound"]["bound_ms"],
                            max_abs_err_ibl=chk["err"])
    by_name["shadow_logsum_tiny"].update(live_ibl=shadow["live"],
                                         opaque_ibl=shadow["opaque"])


# ---- slice 16: adaptive AA and the sampling controls ------------------------


def adaptive_scene(size: int, bounces: int = MAIN["bounces"], **render_params):
    """cornell.xml as pathtracing (the main path's bounces and RR) at
    size², AA_passes 4 on the scene's own AA settings (64 spp, then 16 a
    pass over the pixels the contrast estimator flags at 0.05), with
    `render_params` set on top."""
    return scene_at(
        CORNELL, dict(width=size, height=size, AA_passes=ADAPTIVE_PASSES,
                      **render_params),
        dict(type="pathtracing", bounces=bounces,
             russian_roulette_min_bounces=MAIN["rr_min_bounces"]))


def pass_lines(tag: str, res) -> list:
    """One line per pass of an adaptive render (flagged pixels, lanes,
    compact or dense, steps, wall).  Returns its pass log."""
    log = res.stats["pass_log"]
    for p, e in enumerate(log):
        phase(f"{tag}_pass", **{"pass": p}, flagged=e["flagged"],
              lanes=e["lanes"], mode=e["mode"], steps=e["steps"],
              wall_s=round(e["wall_s"], 4),
              step_ms=round(1e3 * e["wall_s"] / e["steps"], 3))
    return log


def compact_inputs(cs, cfg, film: dict):
    """The next adaptive pass of a rendered film as a compact step: (step,
    scene tensors, lane list), the lanes those compute_aa_flags flags."""
    dev = engine.resolve_device("cuda")
    flags = rmod.adaptive_flags(film, cfg)
    pix = rmod.compact_lanes(flags, int(flags.sum()))
    step = engine.make_sample_step(cs.static, cs.camera, cfg, dev,
                                   compact_n=pix.shape[0])
    return step, to_tensors(cs.arrays, dev), pix


def adaptive_path(smi) -> tuple:
    """The slice's path at 512² through render_scene (its adaptive passes,
    compact where few pixels are flagged), counted; the same render with
    compact=False (films and rays equal); the tiny kernels against their
    plain versions on the rays of a compact pass (dead lanes included);
    one dense and one compact step profiled.  Returns (launches, closest
    check, shadow check)."""
    scene = adaptive_scene(ADAPTIVE_SIZE)
    cfg = build_config(scene)
    res, launches = counted(lambda: render_scene(scene, device="cuda"))
    log = pass_lines("adaptive", res)
    steps = sum(e["steps"] for e in log)
    want = dict.fromkeys(TINY, (cfg.bounces + 1) * steps)
    others = {k: v for k, v in launches.items() if k not in TINY and v}
    launches = {k: launches[k] for k in TINY}
    compact_thr = cfg.aa_threshold
    if not any(e["mode"] == "compact" for e in log):
        # the scene's threshold flags too many pixels for a compact pass:
        # one more render at a threshold whose passes run compact
        compact_thr = 0.3
        extra = render_scene(adaptive_scene(ADAPTIVE_SIZE,
                                            AA_threshold=compact_thr),
                             device="cuda")
        if not any(e["mode"] == "compact"
                   for e in pass_lines("adaptive_compact", extra)):
            raise AssertionError("adaptive_path: no pass ran compact")
    path_line("adaptive_path", res, cfg, launches, want, smi,
              passes=len(log), spp_pass0=cfg.aa_samples,
              spp_per_pass=cfg.aa_inc_samples, threshold=cfg.aa_threshold,
              compact_threshold=compact_thr, steps=steps,
              compact_passes=sum(e["mode"] == "compact" for e in log),
              samples=int(res.film["nsamples"].sum()))
    if others:
        raise AssertionError(f"adaptive_path: kernels off the path {others}")

    dense = render_scene(scene, device="cuda", compact=False)
    equal = {k: bool(torch.equal(res.film[k], dense.film[k]))
             for k in ("wsum", "w", "nsamples")}
    diff = max(float((res.film[k] - dense.film[k]).abs().max())
               for k in ("wsum", "w"))
    phase("adaptive_compact_vs_dense", equal=equal, max_abs_diff=diff,
          rays_compact=res.stats["rays"], rays_dense=dense.stats["rays"],
          render_s_compact=round(res.stats["render_s"], 4),
          render_s_dense=round(dense.stats["render_s"], 4),
          passes_dense=[(e["flagged"], e["mode"], e["steps"])
                        for e in dense.stats["pass_log"]])
    if not all(equal.values()) or res.stats["rays"] != dense.stats["rays"]:
        raise AssertionError("adaptive_compact_vs_dense: films or rays "
                             "differ")
    del dense

    cs = scene.compile(device="cuda")
    step, arrays, pix = compact_inputs(cs, cfg, res.film)
    _, calls = record_calls(ci, ("closest_hit_tiny",
                                 "shadow_transmission_tiny"),
                            lambda: step(arrays, dict(res.film), pix))
    torch.cuda.synchronize()
    c = next(a for k, a in calls if k == "closest_hit_tiny")
    dead = int((pix < 0).sum())
    closest = check_tiny_closest(c[0], c[1:5], c[5], rays_name=(
        f"compact pass primary ({pix.shape[0]} lanes, {dead} dead)"))
    sh = next(a for k, a in calls if k == "shadow_transmission_tiny")
    shadow = check_tiny_shadow(sh[0], ci.log_filter(sh[1]), sh[2:5], sh[5],
                               rays="compact pass bounce-0 NEE")
    del calls, c, sh
    flags = torch.ones((cfg.height, cfg.width), dtype=torch.bool,
                       device=pix.device)
    dense_step = engine.make_sample_step(cs.static, cs.camera, cfg,
                                         pix.device)
    for kind, st, arg, wall in (
            ("dense", dense_step, flags, log[0]["wall_s"] / log[0]["steps"]),
            ("compact", step, pix, next(
                (e["wall_s"] / e["steps"] for e in log
                 if e["mode"] == "compact"), float("nan")))):
        prof = profile_step(st, arrays, cfg, ("tiny_kernel",), arg=arg)
        busy = prof["device_busy_ms"]
        phase("adaptive_profile", step=kind, lanes=int(arg.numel()),
              step_ms=round(1e3 * wall, 3), **prof,
              busy_share=(busy / (1e3 * wall) if isinstance(busy, float)
                          else "not measured"), gpu=repr(smi))
    return launches, closest, shadow


def adaptive_checks() -> None:
    """The physics against the stored golden (96², bounces 6, 4 passes),
    and the card against the CPU at 64² (4 spp, then 2 a pass; the
    scene's threshold, whose passes run dense, and 0.3, whose run
    compact), all deferred."""
    defer_card(adaptive_golden)
    for thr in (None, 0.3):
        defer(adaptive_card_vs_cpu(thr))


def adaptive_golden() -> None:
    """The adaptive path at the golden's 96², bounces 6, 4 passes, against
    the stored golden: RMSE < 0.02."""
    golden = read_exr(GOLDEN)
    gs = golden.shape[0]
    gres = render_scene(adaptive_scene(gs, bounces=6), device="cuda")
    rmse = float(np.sqrt(np.mean((gres.image - golden) ** 2)))
    phase("adaptive_golden", size=f"{gs}x{gs}", bounces=6,
          passes=[(e["flagged"], e["mode"], e["steps"])
                  for e in gres.stats["pass_log"]],
          render_s=round(gres.stats["render_s"], 4), rmse=rmse, bound=0.02)
    if not rmse < 0.02:
        raise AssertionError(f"adaptive golden RMSE {rmse} >= 0.02")


def adaptive_card_vs_cpu(thr):
    """One adaptive render (threshold thr, None the scene's) on the card
    and the CPU: image RMSE <= 1e-4, rays within 0.01%, nsamples equal."""
    over = dict(AA_minsamples=4, AA_inc_samples=2)
    if thr is not None:
        over["AA_threshold"] = thr
    scene = adaptive_scene(64, **over)
    (cpu,) = yield [(render_scene, (scene,), dict(device="cpu"))]
    out = dict(cpu=cpu, cuda=render_scene(scene, device="cuda"))
    rmse = float(np.sqrt(np.mean((out["cuda"].image
                                  - out["cpu"].image) ** 2)))
    r_gpu, r_cpu = out["cuda"].stats["rays"], out["cpu"].stats["rays"]
    rel = abs(r_gpu - r_cpu) / max(r_cpu, 1.0)
    ns_equal = bool(torch.equal(out["cuda"].film["nsamples"].cpu(),
                                out["cpu"].film["nsamples"]))
    phase("adaptive_card_vs_cpu", size="64x64", threshold=thr or 0.05,
          passes=[(e["flagged"], e["mode"]) for e in
                  out["cuda"].stats["pass_log"]], rmse=rmse, bound=1e-4,
          rays_gpu=r_gpu, rays_cpu=r_cpu, rays_rel=rel,
          nsamples_equal=ns_equal)
    if not (rmse <= 1e-4 and rel <= 1e-4 and ns_equal):
        raise AssertionError("adaptive_card_vs_cpu: card and CPU disagree")


def spb_phases(smi) -> tuple:
    """The time-to-RMSE protocol's step: Cornell as pathtracing at 128²,
    64 samples a pixel in one step (1,048,576 lanes), counted; the tiny
    kernels against their plain versions on its primary rays and its
    16,777,216 bounce-0 NEE rays (the plain sum on every 4th); then the
    main path (512², 64 spp) timed at spp_batch 1, 4 and 16, one step of
    each profiled.  Returns (launches, closest check, shadow check)."""
    cs, cfg = cornell(SPB["size"], SPB["spb"], MAIN["bounces"],
                      MAIN["rr_min_bounces"], "cuda")
    cfg = RenderConfig(**{**cfg.__dict__, "spp_batch": SPB["spb"]})
    torch.cuda.reset_peak_memory_stats()
    res, launches = counted(lambda: render(cs, cfg, device="cuda"))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = {k: launches[k] for k in TINY}
    want = dict.fromkeys(TINY, cfg.bounces + 1)
    path_line("spp_batch", res, cfg, launches, want, smi,
              spb=cfg.spp_batch, lanes=cfg.width * cfg.height * cfg.spp_batch,
              steps=len(res.stats["pass_log"]), peak_gib=round(peak, 3))
    if not (res.film["nsamples"] == SPB["spb"]).all():
        raise AssertionError("spp_batch: not 64 samples a pixel")
    step, arrays, rec = step_calls(cs, cfg, ci, ("closest_hit_tiny",
                                                 "shadow_transmission_tiny"))
    c = rec["closest_hit_tiny"][0]
    closest = check_tiny_closest(c[0], c[1:5], c[5],
                                 rays_name="spb 64 primary")
    sh = rec["shadow_transmission_tiny"][0]
    shadow = check_tiny_shadow(sh[0], ci.log_filter(sh[1]), sh[2:5], sh[5],
                               rays="spb 64 bounce-0 NEE",
                               plain_stride=SPB["plain_stride"])
    del rec, c, sh, step, arrays
    torch.cuda.empty_cache()
    mcs, mcfg = cornell(device="cuda", **MAIN)
    for spb in SPB["sweep"]:
        c_spb = RenderConfig(**{**mcfg.__dict__, "spp_batch": spb})
        r, n = counted(lambda: render_timed(mcs, c_spb, device="cuda"))
        prof = profile_step(*path_step(mcs, c_spb), c_spb, ("tiny_kernel",))
        steps = -(-mcfg.aa_samples // spb)
        step_ms = 1e3 * r.stats["render_s"] / steps
        busy = prof["device_busy_ms"]
        phase("spp_batch_sweep", size=f"{mcfg.width}x{mcfg.height}",
              spp=mcfg.aa_samples, spb=spb, steps=steps,
              render_s=round(r.stats["render_s"], 4), rays=r.stats["rays"],
              mrays_per_s=round(r.mrays_per_sec, 3),
              step_ms=round(step_ms, 3),
              kernel_launches=prof.get("kernel_launches"),
              device_busy_ms=busy,
              busy_share=(busy / step_ms if isinstance(busy, float)
                          else "not measured"),
              tiny_launches={k: n[k] for k in TINY}, gpu=repr(smi))
    return launches, closest, shadow


def slice16_phases(smi, kernels: list) -> None:
    """The adaptive path, its checks and the spp_batch step; their launches
    and the tiny kernels' checks on a compact pass's rays and on the spb
    step's go into the tiny kernels' `kernels` entries (`*_adaptive`,
    `*_spb`)."""
    by_name = {k["name"]: k for k in kernels}
    launches, closest, shadow = adaptive_path(smi)
    adaptive_checks()
    l_spb, c_spb, s_spb = spb_phases(smi)
    for tag, n, checks in (("adaptive", launches, (closest, shadow)),
                           ("spb", l_spb, (c_spb, s_spb))):
        for key, chk in zip(TINY, checks):
            by_name[key].update({
                f"launches_{tag}": n[key], f"ms_{tag}": chk["ms"],
                f"plain_ms_{tag}": chk["plain_ms"],
                f"bound_ms_{tag}": chk["bound"]["bound_ms"],
                f"max_abs_err_{tag}": chk["err"]})


# ---- slice 17: BDPT and the DebugIntegrator ---------------------------------


def bdpt_step_launches(cfg, pair=TINY, eye_only: int = 0) -> dict:
    """The (closest hit, shadow sum) kernels' launches in one BDPT step
    (veach.make_bdpt_step's loops): a closest hit per eye vertex (T =
    min(raydepth, 6)) and per light walk vertex (S - 1, S = T); a shadow
    batch per s=1 strategy (t = 2 .. min(T + 1, raydepth + 1)), per inner
    (s, t) with s, t >= 2 and s + t <= raydepth + 2, and per t=1 strategy
    (s = 2 .. min(S, raydepth + 1)); and for each of the eye_only lights
    that cast shadows (outside the strategy set: sun, directional, IES,
    zero flux) one per s=1 vertex of its weight-1 NEE."""
    t_max = s_max = max(1, min(cfg.raydepth, 6))
    cap = cfg.raydepth + 2
    s1 = len(range(2, min(t_max + 1, cap - 1) + 1))
    inner = sum(len(range(2, min(t_max + 1, cap - s) + 1))
                for s in range(2, s_max + 1))
    t1 = len(range(2, min(s_max, cap - 1) + 1))
    return {pair[0]: t_max + s_max - 1,
            pair[1]: s1 + inner + t1 + eye_only * s1}


def bdpt_step(cs, cfg):
    """A BDPT sample step on the card and its scene tensors."""
    dev = engine.resolve_device("cuda")
    return veach.make_bdpt_step(cs, cfg, dev), to_tensors(cs.arrays, dev)


def bidir_path(smi) -> tuple:
    """cornell_bidir.xml at its own settings (bidirectional, raydepth 3,
    512², 64 spp, box filter 1.5) through render_scene(timed=True),
    counted: each tiny kernel launched bdpt_step_launches a step, the
    warm-up step included, and no other kernel.  Returns (scene, config,
    result, launches a step)."""
    scene = scene_at(BIDIR)
    cfg = build_config(scene)
    torch.cuda.reset_peak_memory_stats()
    res, launches = entry_counted(scene, TINY)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    per_step = bdpt_step_launches(cfg)
    steps = cfg.aa_samples * cfg.aa_passes
    want = {k: v * (steps + 1) for k, v in per_step.items()}
    dens = res.film["density"]
    path_line("bidir_path", res, cfg, launches, want, smi,
              spp=cfg.aa_samples, raydepth=cfg.raydepth,
              filter=f"{cfg.filter_type}:{cfg.aa_pixelwidth}",
              steps=res.stats["bdpt_steps"], launches_per_step=per_step,
              step_ms=round(1e3 * res.stats["render_s"] / steps, 3),
              peak_gib=round(peak, 3),
              density_mean=float(dens.mean()),
              density_max=float(dens.max()))
    if not float(dens.mean()) > 0.0:
        raise AssertionError("bidir_path: the t=1 splats left no density")
    return scene, cfg, res, per_step


def bidir_kernels(cs, cfg) -> tuple:
    """One BDPT step at 512² with the tiny wrappers recording their
    arguments: every call held to its plain version (closest hit: hit and
    tri equal, t/u/v within rtol 1e-4 and bit-equal; transmission within
    atol 2e-3 and bit-equal), its shape and live lanes printed; the
    light walk's first closest hit (rays leaving the emitter) and the
    first inner connection's shadow batch (segments of any length, dead
    lanes at dist -1) also timed with their bounds (check_tiny_closest /
    check_tiny_shadow).  Returns (closest check, shadow check, calls)."""
    step, arrays = bdpt_step(cs, cfg)
    dev = engine.resolve_device("cuda")
    flags = torch.ones((cfg.height, cfg.width), dtype=torch.bool, device=dev)
    _, calls = record_calls(ci, ("closest_hit_tiny",
                                 "shadow_transmission_tiny"),
                            lambda: step(arrays, _fresh_film(cfg, dev),
                                         flags))
    torch.cuda.synchronize()
    closest = [a for k, a in calls if k == "closest_hit_tiny"]
    shadow = [a for k, a in calls if k == "shadow_transmission_tiny"]
    t_max = max(1, min(cfg.raydepth, 6))
    for i, a in enumerate(closest):
        got = ci.closest_hit_tiny(*a)
        want = ci.closest_hit_tiny_plain(*a)
        torch.cuda.synchronize()
        hit = want[4]
        ok = (torch.equal(got[4], hit)
              and torch.equal(got[1][hit], want[1][hit])
              and all(torch.allclose(got[j][hit], want[j][hit], rtol=1e-4)
                      for j in (0, 2, 3)))  # t, u, v
        n_diff = differ(got[:4], want[:4])
        phase("bidir_call", kernel="closest_hit_tiny", call=i,
              walk="eye" if i < t_max else "light", n=a[1].shape[0],
              live=int((a[3] <= a[4]).sum()), hits=int(hit.sum()),
              differ=n_diff)
        if not ok or n_diff:
            raise AssertionError(f"bidir closest_hit_tiny call {i} differs "
                                 "from its plain version")
    for i, (pk, f4, org, dirn, dist, n_tris) in enumerate(shadow):
        logf = ci.log_filter(f4)
        got = ci.shadow_logsum_tiny(pk, logf, org, dirn, dist, n_tris)
        want = ci.shadow_logsum_tiny_plain(pk, logf, org, dirn, dist, n_tris)
        torch.cuda.synchronize()
        err = float((torch.exp(got) - torch.exp(want)).abs().max())
        n_diff = int((got != want).any(dim=-1).sum())
        phase("bidir_call", kernel="shadow_logsum_tiny", call=i,
              n=org.shape[0], live=int((dist > 0).sum()),
              opaque=int((got <= -80.0).all(dim=-1).sum()),
              max_abs_err=err, differ=n_diff)
        if err > 2e-3 or n_diff:
            raise AssertionError(f"bidir shadow_logsum_tiny call {i} "
                                 "differs from its plain version")
    c = closest[t_max]
    c_chk = check_tiny_closest(c[0], c[1:5], c[5],
                               rays_name="bidir light walk 1")
    s1 = len(range(2, min(t_max + 1, cfg.raydepth + 1) + 1))
    sh = shadow[s1]
    s_chk = check_tiny_shadow(sh[0], ci.log_filter(sh[1]), sh[2:5], sh[5],
                              rays="bidir inner (2,2)")
    return c_chk, s_chk, (len(closest), len(shadow))


def bidir_golden() -> None:
    """cornell_bidir.xml at the golden's 96², 48 spp against
    scenes/goldens/cornell_bidir.exr: RMSE < 0.035, the reference's own
    bound (its test_render_matches_golden_bidir)."""
    golden = read_exr(BIDIR_GOLDEN)
    gs = golden.shape[0]
    res = render_scene(scene_at(BIDIR, dict(
        width=gs, height=gs, AA_minsamples=BIDIR_GOLDEN_SPP, AA_passes=1)),
        device="cuda")
    rmse = float(np.sqrt(np.mean((res.image - golden) ** 2)))
    phase("bidir_golden", size=f"{gs}x{gs}", spp=BIDIR_GOLDEN_SPP,
          render_s=round(res.stats["render_s"], 4), rmse=rmse, bound=0.035)
    if not rmse < 0.035:
        raise AssertionError(f"bidir golden RMSE {rmse} >= 0.035")


def bidir_card_vs_cpu():
    """The same render on the card and on the CPU at 32², 4 spp: image RMSE
    <= 1e-4, the density plane RMSE <= 1e-5, rays equal; and the card
    twice, whose density planes may differ in their last bits (the t=1
    splat adds through atomics) while the eye-side film planes may not."""
    scene = scene_at(BIDIR, dict(width=BIDIR_SMALL["size"],
                                 height=BIDIR_SMALL["size"],
                                 AA_minsamples=BIDIR_SMALL["spp"]))
    (cpu,) = yield [(render_scene, (scene,), dict(device="cpu"))]
    out = dict(cpu=cpu, cuda=render_scene(scene, device="cuda"))
    again = render_scene(scene, device="cuda")
    gpu, cpu = out["cuda"], out["cpu"]
    rmse = float(np.sqrt(np.mean((gpu.image - cpu.image) ** 2)))
    dg, dc = gpu.film["density"].cpu().numpy(), cpu.film["density"].numpy()
    d_rmse = float(np.sqrt(np.mean((dg - dc) ** 2)))
    d_again = (again.film["density"] - gpu.film["density"]).abs()
    eye_equal = all(torch.equal(again.film[k], gpu.film[k])
                    for k in ("wsum", "w", "nsamples"))
    phase("bidir_card_vs_cpu", size=f"{BIDIR_SMALL['size']}x"
          f"{BIDIR_SMALL['size']}", spp=BIDIR_SMALL["spp"], rmse=rmse,
          bound=1e-4, density_rmse=d_rmse, density_bound=1e-5,
          density_max_abs=float(np.abs(dg - dc).max()),
          density_mean=float(dc.mean()), rays_gpu=gpu.stats["rays"],
          rays_cpu=cpu.stats["rays"],
          repeat_density_differ=int((d_again > 0).any(dim=-1).sum()),
          repeat_density_max_abs=float(d_again.max()),
          repeat_eye_planes_equal=eye_equal)
    if not (rmse <= 1e-4 and d_rmse <= 1e-5
            and gpu.stats["rays"] == cpu.stats["rays"] and eye_equal):
        raise AssertionError("bidir_card_vs_cpu: card and CPU disagree")


def cli_copy(tag: str, path: str, spp_from: int, size: int, spp: int,
             smi, out_dir: str) -> None:
    """A scene of the repository through the port's CLI at size² with
    --json-stats, its samples cut from spp_from to spp a pixel in a copy
    of the scene (the CLI has no samples option): the .exr read back equal
    to the image of the render_scene call the CLI made (recorded), and the
    --json-stats rays to its rays."""
    from libyafaray_tpu_torch.scene import session

    xml = os.path.join(out_dir, f"{tag}.xml")
    with open(path) as f:
        text = f.read()
    key = '<AA_minsamples ival="{}"/>'
    if key.format(spp_from) not in text:
        raise AssertionError(f"{path}: no AA_minsamples {spp_from}")
    with open(xml, "w") as f:
        f.write(text.replace(key.format(spp_from), key.format(spp)))
    out = os.path.join(out_dir, f"{tag}.exr")
    real, results = session.render_scene, []

    def recorded(*args, **kwargs):
        results.append(real(*args, **kwargs))
        return results[-1]

    buf = io.StringIO()
    session.render_scene = recorded
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli_main([xml, out, "--json-stats", "-vl", "warning",
                           "--width", str(size), "--height", str(size)])
    finally:
        session.render_scene = real
    stats = json.loads([line for line in buf.getvalue().splitlines()
                        if line.startswith("{")][-1])
    img = read_exr(out)
    res = results[0]
    rmse = float(np.sqrt(np.mean((img - res.image) ** 2)))
    phase(tag, rc=rc, output=os.path.basename(out), shape=img.shape,
          integrator=res.cfg.integrator, spp=res.cfg.aa_samples,
          wall_s=round(stats["wall_s"], 4),
          render_s=round(stats["render_s"], 4), rays=stats["rays"],
          rays_render_scene=res.stats["rays"],
          mrays_per_s=round(stats["mrays_per_sec"], 3), rmse_vs_path=rmse,
          bound=1e-4, gpu=repr(smi))
    if rc != 0 or len(results) != 1 or img.shape != (size, size, 3):
        raise AssertionError(f"{tag}: no image of the path's shape")
    if not (np.all(np.isfinite(img)) and stats["rays"] == res.stats["rays"]
            and rmse <= 1e-4 and res.cfg.aa_samples == spp):
        raise AssertionError(f"{tag}: the CLI's output disagrees with its "
                             "render")


def bidir_cli(smi, out_dir: str) -> None:
    """cornell_bidir.xml through the port's CLI at 64², 16 spp (a BDPT
    step is host-paced at ~0.4 s at any size)."""
    cli_copy("bidir_cli", BIDIR, 64, BIDIR_SMALL["cli_size"],
             BIDIR_SMALL["cli_spp"], smi, out_dir)


def debug_path(smi) -> dict:
    """The DebugIntegrator on cornell.xml at 512² through render_scene,
    counted (one closest_hit_tiny launch, nothing else), its N image
    against the CPU's within atol 1e-6."""
    scene = scene_at(CORNELL, integrator=dict(type="DebugIntegrator"))
    res, launches = counted(lambda: render_scene(scene, device="cuda"))
    want = {"closest_hit_tiny": 1}
    got = {k: v for k, v in launches.items() if v}
    cpu = render_scene(scene, device="cpu")
    err = float(np.abs(res.image - cpu.image).max())
    hit = int((res.image.max(axis=-1) > 0.0).sum())
    phase("debug_path", size=f"{res.cfg.width}x{res.cfg.height}",
          image="N", render_s=round(res.stats["render_s"], 4),
          rays=res.stats["rays"], hit_pixels=hit, launches=got,
          expected_launches=want, max_abs_err_vs_cpu=err, bound=1e-6,
          gpu=repr(smi))
    if got != want or not err <= 1e-6 or hit == 0:
        raise AssertionError("debug_path: launches or image off")
    return got


def slice17_phases(smi, out_dir: str, kernels: list) -> None:
    """BDPT on cornell_bidir.xml (path, kernels on its recorded calls, a
    profiled step, golden, card vs CPU, CLI) and the DebugIntegrator; the
    BDPT launches and the tiny kernels' checks on its rays go into their
    `kernels` entries (`*_bidir`)."""
    scene, cfg, res, per_step = bidir_path(smi)
    cs = scene.compile(device="cuda")
    closest, shadow, n_calls = bidir_kernels(cs, cfg)
    if n_calls != (per_step["closest_hit_tiny"],
                   per_step["shadow_logsum_tiny"]):
        raise AssertionError(f"bidir step recorded {n_calls} calls, "
                             f"expected {per_step}")
    step, arrays = bdpt_step(cs, cfg)
    profile("bidir_profile", res, lambda a, f, fl: step(a, f, fl)[0],
            arrays, cfg, ("tiny_kernel",), smi)
    del step, arrays
    defer_card(bidir_golden)
    defer(bidir_card_vs_cpu())
    bidir_cli(smi, out_dir)
    debug = debug_path(smi)
    by_name = {k["name"]: k for k in kernels}
    for key, chk in (("closest_hit_tiny", closest),
                     ("shadow_logsum_tiny", shadow)):
        if key not in by_name:  # a run of --only slice17
            continue
        by_name[key].update(
            launches_bidir_step=per_step[key], ms_bidir=chk["ms"],
            plain_ms_bidir=chk["plain_ms"],
            bound_ms_bidir=chk["bound"]["bound_ms"],
            max_abs_err_bidir=chk["err"])
    if "closest_hit_tiny" in by_name:
        by_name["closest_hit_tiny"]["launches_debug"] = debug[
            "closest_hit_tiny"]


# ---- slice 18: every light type on scenes/cornell_lights.xml -------------


LT_NAMES = {lightmod.LT_POINT: "point", lightmod.LT_AREA: "area",
            lightmod.LT_SPHERE: "sphere", lightmod.LT_SPOT: "spot",
            lightmod.LT_SUN: "sun", lightmod.LT_DIRECTIONAL: "directional",
            lightmod.LT_MESH: "mesh", lightmod.LT_BACKGROUND: "ibl",
            lightmod.LT_IES: "ies", lightmod.LT_PORTAL: "portal"}


def nee_lights(static) -> int:
    """Lights whose NEE traces a shadow batch at every path vertex."""
    return sum(ls.enabled and not ls.photon_only and ls.cast_shadows
               for ls in static.lights)


def lights_scene() -> tuple:
    """cornell_lights.xml compiled for the card: 352 triangles, both packs
    on the dense route, the IES light's profile equal to parse_ies of its
    file (not the isotropic fallback), the meshlight enabled on mesh 4's 2
    triangles.  Returns (scene, config, compiled scene)."""
    t0 = time.perf_counter()
    scene = scene_at(LIGHTS)
    cfg = build_config(scene)
    cs = scene.compile(device="cuda")
    a, st = cs.arrays, cs.static
    routes = (isect.route(a["tri_pack10"], a["tri_cluster8"],
                          st.n_tris_real),
              isect.route(a["stri_pack10"], a["stri_cluster8"],
                          st.n_stris_real))
    ies_keys = [k for k in a if k.startswith("ies_")]
    ies_equal = bool(ies_keys) and all(
        np.array_equal(a[k], parse_ies(LIGHTS_IES)) for k in ies_keys)
    mesh = [ls for ls in st.lights if ls.ltype == lightmod.LT_MESH]
    phase("lights_scene", tris=st.n_tris_real, routes=routes,
          lights=[LT_NAMES[ls.ltype] for ls in st.lights],
          nee_samples=[ls.samples for ls in st.lights],
          ies=f"{LIGHTS_IES} {a[ies_keys[0]].shape if ies_keys else None}",
          ies_equal_parse=ies_equal,
          meshlight=[(ls.enabled, ls.tri_start, ls.tri_count)
                     for ls in mesh],
          integrator=cfg.integrator, bounces=cfg.bounces,
          size=f"{cfg.width}x{cfg.height}", spp=cfg.aa_samples,
          compile_s=round(time.perf_counter() - t0, 3))
    if routes != ("dense", "dense") or st.n_tris_real != 352:
        raise AssertionError(f"lights_scene: {st.n_tris_real} triangles "
                             f"routed {routes}")
    if not ies_equal or len(mesh) != 1 or not mesh[0].enabled \
            or mesh[0].tri_count != 2:
        raise AssertionError("lights_scene: the IES profile or the "
                             "meshlight did not load")
    return scene, cfg, cs


def lights_kernels(cs, cfg) -> dict:
    """The dense kernels against their plain versions on one 512² step's
    recorded calls: the primary rays, and the bounce-0 NEE batches of the
    point light (finite segments) and of the sun (segments of 1e8)."""
    _, _, calls = step_calls(cs, cfg, cx, DENSE)
    types = [ls.ltype for ls in cs.static.lights]
    shadow = calls[DENSE[1]]
    point = shadow[types.index(lightmod.LT_POINT)]
    sun = shadow[types.index(lightmod.LT_SUN)]
    if not float(sun[6].max()) == 1e8 or float(point[6].max()) >= 1e8:
        raise AssertionError("lights_kernels: the recorded NEE batches are "
                             "not the point light's and the sun's")
    out = dict(closest=check_mid_closest("dense", calls[DENSE[0]][0],
                                         "lights primary"),
               point=check_mid_shadow("dense", point,
                                      "lights bounce-0 NEE point"),
               sun=check_mid_shadow("dense", sun,
                                    "lights bounce-0 NEE sun (1e8)"))
    del calls, shadow
    return out


def lights_path(smi, cs, cfg) -> dict:
    """cornell_lights.xml at its own settings (pathtracing, bounces 4,
    512², 64 spp) through render_scene(timed=True), counted: per step a
    closest hit per vertex and a shadow batch per vertex and light, the
    warm-up step included, nothing else; one profiled step."""
    scene = scene_at(LIGHTS)
    res, launches = entry_counted(scene, DENSE)
    verts = cfg.bounces + 1
    per_step = {DENSE[0]: verts, DENSE[1]: verts * nee_lights(cs.static)}
    steps = cfg.aa_samples + 1
    path_line("lights_path", res, cfg, launches,
              {k: v * steps for k, v in per_step.items()}, smi,
              spp=cfg.aa_samples, bounces=cfg.bounces,
              launches_per_step=per_step,
              step_ms=round(1e3 * res.stats["render_s"] / cfg.aa_samples,
                            3))
    profile("lights_profile", res, *path_step(cs, cfg), cfg,
            ("closest_dense_kernel", "shadow_dense_kernel"), smi)
    return launches


def lights_bidir(smi) -> dict:
    """The scene as bidirectional at 512², 16 spp through
    render_scene(timed=True), counted: bdpt_step_launches a step (the
    sun, directional and IES lights through the eye-side NEE)."""
    scene = scene_at(LIGHTS, dict(AA_minsamples=LIGHTS_BIDIR_SPP),
                     dict(type="bidirectional"))
    cfg = build_config(scene)
    st = scene.compile(device="cuda").static
    eye = sum(ls.enabled and ls.cast_shadows
              and ls.ltype not in veach._BD_LIGHT_TYPES
              for ls in st.lights)
    res, launches = entry_counted(scene, DENSE)
    per_step = bdpt_step_launches(cfg, DENSE, eye_only=eye)
    steps = cfg.aa_samples * cfg.aa_passes
    dens = res.film["density"]
    path_line("lights_bidir", res, cfg, launches,
              {k: v * (steps + 1) for k, v in per_step.items()}, smi,
              spp=cfg.aa_samples, raydepth=cfg.raydepth,
              launches_per_step=per_step, eye_only_lights=eye,
              step_ms=round(1e3 * res.stats["render_s"] / steps, 3),
              density_mean=float(dens.mean()),
              density_max=float(dens.max()))
    if not float(dens.mean()) > 0.0:
        raise AssertionError("lights_bidir: the t=1 splats left no density")
    return launches


def photons_by_light(cs, cfg, info, device="cuda") -> dict:
    """The stored photons of each map by the type of the light that
    emitted them: each map's passes shot again as build_photon_maps shoots
    them (lanes, seeds 1000 + p and 9000 + p), each lane's light picked
    again from the power CDF as make_photon_pass picks it.  The totals
    must equal the render's stored counts."""
    from libyafaray_tpu_torch.integrators.photon_shoot import \
        make_photon_pass

    arrays = to_tensors(cs.arrays, device)
    cdf, _ = photonmap._light_cdf(cs.static, cs.arrays["lights"])
    cdf = np.asarray(cdf, np.float32)
    out = {}
    for m, seed0 in (("diffuse", 1000), ("caustic", 9000)):
        lanes, passes = info[m]["lanes"], info[m]["passes"]
        shoot = make_photon_pass(cs.static, cfg, lanes, cfg.photon_bounces,
                                 m)
        counts = {}
        for p in range(passes):
            rec = shoot(arrays, cdf, seed0 + p)
            lane = torch.arange(lanes, dtype=torch.int32, device=device)
            skey = qmc.hash_combine(lane, qmc.word_like(lane, seed0 + p))
            u = qmc.sample_dim(torch.zeros_like(lane), 0, skey)
            pick = torch.zeros_like(lane)
            for li in range(len(cs.static.lights)):
                pick = torch.where(u >= float(cdf[li]), li, pick)
            stored = rec["valid"].reshape(-1, lanes).sum(dim=0)
            for li, ls in enumerate(cs.static.lights):
                name = LT_NAMES[ls.ltype]
                counts[name] = counts.get(name, 0) + int(
                    stored[pick == li].sum())
        if sum(counts.values()) != info[m]["stored"]:
            raise AssertionError(f"photons_by_light ({m}): {counts} do not "
                                 f"add up to {info[m]['stored']}")
        out[m] = counts
    return out


def lights_photon(smi) -> tuple:
    """The scene as photonmapping at 512², 16 spp, 200,000 + 100,000
    photons, final gather 16, through render_scene(timed=True), counted
    (photon_launch_counts on the dense kernels); the stored photons by
    light type (the meshlight's flux enters the power CDF, its photons
    leave with none, as the reference's do; sun, directional and IES emit
    none); the gathers against their plain versions at this variant's
    shapes (the radiance precompute's first density gather, the step's
    first final-gather lookup; its caustic map is empty: no specular
    surface).  Returns (launches, density check, nearest check)."""
    scene = scene_at(LIGHTS, dict(AA_minsamples=LIGHTS_PHOTON_SPP),
                     LIGHTS_PHOTON)
    cfg = build_config(scene)
    cs = scene.compile(device="cuda")
    names = DENSE + ("density_flash", "nearest_flash")
    res, launches = entry_counted(scene, names)
    info = res.stats["photon_maps"]
    by_light = photons_by_light(cs, cfg, info)
    want = photon_launch_counts(cfg, info, DENSE, nee_lights(cs.static))
    path_line("lights_photon", res, cfg, launches, want, smi,
              spp=cfg.aa_samples, photons=cfg.photons,
              caustic_photons=cfg.caustic_photons,
              fg_samples=cfg.fg_samples,
              preprocess_s=round(res.stats["preprocess_s"], 4),
              stored={m: info[m]["stored"] for m in ("diffuse", "caustic")},
              stored_by_light=by_light)
    d = by_light["diffuse"]
    if not (d["point"] and d["spot"] and d["sphere"]) or any(
            d[k] for k in ("mesh", "sun", "directional", "ies")):
        raise AssertionError(f"lights_photon: stores by light {d}")
    _, _, pre, step = photon_inputs(cs, cfg)
    radiance = next(a for n, a in pre if n == "density_auto")
    diffuse = next(a for n, a in pre if n == "make_photon_pack_auto")
    photons = next(a for n, a in pre if n == "make_photon_pack_lookup")
    nearest = next(a for n, a in step if n == "nearest_flash")
    dens = check_density("lights radiance", radiance, diffuse)
    near = check_nearest(nearest, photons, "lights final gather")
    return launches, dens, near


def entry_vs_cpu(what, make, bound_img, tag="lights_card_vs_cpu",
                 **kw) -> None:
    """make() -> a fresh scene, rendered through render_scene on the card
    and on the CPU: image RMSE <= bound_img, rays within rays_rel (default
    1e-4), the density layer RMSE <= density (where given), the photon
    maps' stored counts within stored_rel (where given).  Deferred
    (`defer`); make() is called now, once for each device."""
    defer(_entry_vs_cpu(what, make(), make(), bound_img, tag, kw))


def _entry_vs_cpu(what, card_scene, cpu_scene, bound_img, tag, kw):
    (c,) = yield [(render_scene, (cpu_scene,), dict(device="cpu"))]
    g = render_scene(card_scene, device="cuda")
    rmse = float(np.sqrt(np.mean((g.image - c.image) ** 2)))
    rel = abs(g.stats["rays"] - c.stats["rays"]) / max(c.stats["rays"], 1.0)
    extra, ok = {}, rmse <= bound_img and rel <= kw.get("rays_rel", 1e-4)
    if "density" in kw:
        dg, dc = g.film["density"].cpu().numpy(), c.film["density"].numpy()
        extra["density_rmse"] = float(np.sqrt(np.mean((dg - dc) ** 2)))
        extra["density_bound"] = kw["density"]
        ok = ok and extra["density_rmse"] <= kw["density"]
    if "stored_rel" in kw:
        for m in ("diffuse", "caustic"):
            a = g.stats["photon_maps"][m]["stored"]
            b = c.stats["photon_maps"][m]["stored"]
            extra[f"stored_{m}"] = f"{a}/{b}"
            ok = ok and abs(a - b) <= kw["stored_rel"] * max(b, 1)
    phase(tag, scene=what,
          size=f"{g.cfg.width}x{g.cfg.height}",
          integrator=g.cfg.integrator, spp=g.cfg.aa_samples, rmse=rmse,
          bound=bound_img, rays_gpu=g.stats["rays"],
          rays_cpu=c.stats["rays"], rays_rel=rel, **extra)
    if not ok:
        raise AssertionError(f"{tag} ({what}, "
                             f"{g.cfg.integrator}): card and CPU disagree")


def quad_mesh(s, mesh_id, corners, mat, tris=((0, 1, 2), (0, 2, 3))):
    s.start_tri_mesh(mesh_id, has_uv=False, visibility="normal")
    for p in corners:
        s.add_vertex(*(float(x) for x in p))
    for a, b, c in tris:
        s.add_triangle(a, b, c, mat)
    s.end_tri_mesh()


def flat_scene(s, integrator, res, spp, cam, **integ):
    """Camera, integrator and render block of a scene built through the
    flat API (the reference tests' scenes)."""
    s.create_camera("cam", ParamMap(dict(type="perspective", resx=res,
                                         resy=res, **cam)))
    s.create_integrator("default", ParamMap(dict(type=integrator, **integ)))
    s.render_params = ParamMap({"width": res, "height": res,
                                "AA_minsamples": spp,
                                "integrator_name": "default",
                                "camera_name": "cam"})
    return s


def portal_room(res, spp):
    """The reference's bgPortalLight room: an open-top box lit by a
    constant background through a portal over its top, directlighting."""
    s = Scene()
    white = s.create_material("white", ParamMap(
        type="shinydiffusemat", color=(0.7, 0.7, 0.7)))
    hole = s.create_material("hole", ParamMap(type="null"))
    s.create_background("bg", ParamMap(type="constant",
                                       color=(2.0, 2.0, 2.0)))
    quad_mesh(s, 1, ((-1, -1, 0), (1, -1, 0), (1, 1, 0), (-1, 1, 0),
                     (-1, -1, 2), (1, -1, 2), (1, 1, 2), (-1, 1, 2)), white,
              tris=[t for a, b, c, d in ((0, 1, 2, 3), (0, 1, 5, 4),
                                         (1, 2, 6, 5), (2, 3, 7, 6),
                                         (3, 0, 4, 7))
                    for t in ((a, b, c), (a, c, d))])
    quad_mesh(s, 2, ((-1, -1, 2), (1, -1, 2), (1, 1, 2), (-1, 1, 2)), hole,
              tris=((0, 2, 1), (0, 3, 2)))
    s.create_light("P", ParamMap(type="bgPortalLight", object_name="2",
                                 samples=8))
    return flat_scene(s, "directlighting", res, spp, {
        "from": (0.0, -0.8, 1.0), "to": (0.0, 0.5, 0.6),
        "up": (0.0, -0.8, 2.0), "focal": 0.8}, raydepth=1)


def lights_card_vs_cpu() -> None:
    """The card against the CPU within PERF.md §2's bounds: the scene as
    pathtracing and directlighting at 64², 4 spp, BDPT at 32², 4 spp,
    photonmapping at 32², 2 spp with 16,384 photons, SPPM at 32², 2
    passes, and the portal room at 64², 4 spp."""
    small = dict(width=64, height=64, AA_minsamples=4)
    tiny = dict(width=32, height=32, AA_minsamples=4)
    for integ in ("pathtracing", "directlighting"):
        entry_vs_cpu("cornell_lights", lambda: scene_at(
            LIGHTS, small, dict(type=integ)), 1e-4)
    entry_vs_cpu("cornell_lights", lambda: scene_at(
        LIGHTS, tiny, dict(type="bidirectional")), 1e-4, density=1e-5)
    entry_vs_cpu("cornell_lights", lambda: scene_at(
        LIGHTS, dict(tiny, AA_minsamples=2), dict(
            type="photonmapping", photons=16_384, cPhotons=8192,
            fg_samples=4)), 1e-3, rays_rel=1e-3, stored_rel=1e-3)
    entry_vs_cpu("cornell_lights", lambda: scene_at(
        LIGHTS, dict(tiny, AA_minsamples=1), dict(
            type="SPPM", photons=16_384, passNums=2)), 1e-3, rays_rel=1e-3,
        density=1e-3)
    entry_vs_cpu("portal_room", lambda: portal_room(64, 4), 1e-4)


def box_light(kind: str, res: int):
    """A floor under an arealight or an equal double-sided meshlight
    quad, directlighting raydepth 2, 16 spp (the reference's
    test_meshlight_matches_arealight)."""
    s = Scene()
    white = s.create_material("white", ParamMap(
        type="shinydiffusemat", color=(0.7, 0.7, 0.7)))
    s.create_background("bg", ParamMap(type="constant", color=(0, 0, 0)))
    quad_mesh(s, 1, ((-2, -2, 0), (2, -2, 0), (2, 2, 0), (-2, 2, 0)), white)
    c = np.array([-0.5, -0.5, 2.0])
    e1, e2 = np.array([1.0, 0.0, 0.0]), np.array([0.0, 1.0, 0.0])
    if kind == "area":
        s.create_light("L", ParamMap(
            type="arealight", corner=tuple(c), point1=tuple(c + e2),
            point2=tuple(c + e1), color=(1.0, 1.0, 1.0), power=10.0,
            samples=8))
    else:
        quad_mesh(s, 2, (c, c + e2, c + e1 + e2, c + e1), white)
        s.create_light("L", ParamMap(
            type="meshlight", object_name="2", color=(1.0, 1.0, 1.0),
            power=10.0, samples=8, double_sided=True))
    return flat_scene(s, "directlighting", res, 16, {
        "from": (0.0, -5.0, 1.0), "to": (0.0, 0.0, 0.5),
        "up": (0.0, -5.0, 2.0), "focal": 1.2}, raydepth=2)


def sphere_light(integrator: str, res: int):
    s = Scene()
    floor = s.create_material("floor", ParamMap(
        type="shinydiffusemat", color=(0.8, 0.8, 0.8), diffuse_reflect=0.9))
    s.create_light("L", ParamMap(type="spherelight", radius=0.7, power=30.0,
                                 color=(1.0, 1.0, 1.0), samples=8,
                                 **{"from": (0.0, 0.0, 2.0)}))
    quad_mesh(s, 1, ((-4, -4, 0), (4, -4, 0), (4, 4, 0), (-4, 4, 0)), floor)
    return flat_scene(s, integrator, res, 24, {
        "from": (0.0, -6.0, 3.0), "to": (0.0, 0.0, 0.5),
        "up": (0.0, -6.0, 4.0), "focal": 1.2}, raydepth=2, bounces=2)


def veach_box(integrator: str, lights, res: int, spp: int):
    """tests/test_veach.py's box: a floor and a back wall, bounces 3,
    raydepth 4."""
    s = Scene()
    white = s.create_material("white", ParamMap(
        type="shinydiffusemat", color=(0.7, 0.7, 0.7)))
    for name, params in lights:
        s.create_light(name, ParamMap(params))
    quad_mesh(s, 1, ((-2, -2, 0), (2, -2, 0), (2, 2, 0), (-2, 2, 0),
                     (-2, 2, 0), (2, 2, 0), (2, 2, 3), (-2, 2, 3)), white,
              tris=((0, 1, 2), (0, 2, 3), (4, 5, 6), (4, 6, 7)))
    return flat_scene(s, integrator, res, spp, {
        "from": (0.0, -5.0, 1.2), "to": (0.0, 0.0, 0.9),
        "up": (0.0, -5.0, 2.2), "focal": 1.4}, bounces=3, raydepth=4)


def spot_floor(soft: bool, res: int):
    s = Scene()
    floor = s.create_material("floor", ParamMap(
        type="shinydiffusemat", color=(1.0, 1.0, 1.0)))
    blk = s.create_material("blk", ParamMap(
        type="shinydiffusemat", color=(0.0, 0.0, 0.0)))
    p = {"type": "spotlight", "from": (0.0, 0.0, 4.0), "to": (0.0, 0.0, 0.0),
         "cone_angle": 60.0, "power": 40.0, "color": (1.0, 1.0, 1.0)}
    if soft:
        p.update(soft_shadows=True, shadowFuzzyness=0.4, samples=16)
    s.create_light("L", ParamMap(p))
    s.start_tri_mesh(1, has_uv=False, visibility="normal")
    for v in ((-3, -3, 0), (3, -3, 0), (3, 3, 0), (-3, 3, 0), (0, -3, 2),
              (0, 3, 2), (1.5, -3, 2), (1.5, 3, 2)):
        s.add_vertex(*(float(x) for x in v))
    for a, b, c, m in ((0, 1, 2, floor), (0, 2, 3, floor), (4, 6, 7, blk),
                       (4, 7, 5, blk)):  # the floor, a black blocker
        s.add_triangle(a, b, c, m)
    s.end_tri_mesh()
    return flat_scene(s, "directlighting", res, 4, {
        "from": (0.0, 0.0, 6.0), "to": (0.0, 0.001, 0.0),
        "up": (0.0, 1.0, 6.0), "focal": 1.0}, raydepth=1)


def lights_physics(smi) -> None:
    """The reference's light physics on the card at 128² (its tests'
    bounds): meshlight vs arealight floor (mean abs difference < 0.15 ×
    the mean), sphere light pathtracing vs directlighting (means within
    10%, the sphere seen), BDPT vs pathtracing with a point light (6%),
    sun and directional under BDPT (lit, 8%), the spot's soft_shadows
    widening its penumbra: by more than 0.01 of the image width at 128²,
    and by the reference's own measure at its 48² (the share of pixels
    between lit and shadowed, + 0.01)."""
    r = LIGHTS_PHYSICS_RES
    k = r // 32  # the reference tests' 32² windows, scaled

    def img(s):
        return render_scene(s, device="cuda").image

    fa = img(box_light("area", r))[20 * k:]
    fm = img(box_light("mesh", r))[20 * k:]
    mesh_rel = float(np.abs(fa - fm).mean() / fa.mean())
    ip, idl = img(sphere_light("pathtracing", r)), img(
        sphere_light("directlighting", r))
    sphere_rel = abs(float(ip.mean()) - float(idl.mean())) / float(
        idl.mean())
    seen = bool(ip[2 * k:12 * k, 10 * k:22 * k].max() > ip[20 * k:].max())
    point = [("P", {"type": "pointlight", "from": (0.0, 0.0, 1.9),
                    "power": 6.0, "color": (1.0, 1.0, 1.0)})]
    mb, mp = (float(img(veach_box(i, point, r, 16)).mean())
              for i in ("bidirectional", "pathtracing"))
    sun = [("S", {"type": "sunlight", "direction": (0.3, 0.3, 1.0),
                  "power": 2.0, "color": (1.0, 1.0, 1.0), "angle": 0.5}),
           ("D", {"type": "directional", "direction": (-0.2, 0.1, 1.0),
                  "power": 1.0, "color": (1.0, 0.9, 0.8)})]
    sb, sp_ = (float(img(veach_box(i, sun, r, 4)).mean())
               for i in ("bidirectional", "pathtracing"))

    def edge_frac(im):
        # the reference's measure: the share of pixels between lit and
        # shadowed (its bound, 0.01, is set at its 48² size)
        v = im[..., 0]
        lit = np.percentile(v[v > 1e-4], 90)
        return float(((v > 0.15 * lit) & (v < 0.7 * lit)).mean())

    def edge_width(im):
        # the penumbra's width on the lit side of the blocker's shadow
        # edge (the image's centre column), over the middle rows: the
        # pixels below 0.9 of the lit floor a quarter width away, as a
        # share of the image width (independent of the resolution)
        v = im[..., 0]
        h, w = v.shape
        rows = v[h // 3:2 * h // 3]
        band = (rows[:, w // 4:w // 2] if rows[:, w // 4].mean()
                > rows[:, 3 * w // 4].mean()
                else rows[:, w // 2:3 * w // 4][:, ::-1])
        return float((band < 0.9 * band[:, :1]).sum(axis=1).mean()) / w

    hard, soft = (edge_width(img(spot_floor(f, r))) for f in (False, True))
    hard48, soft48 = (edge_frac(img(spot_floor(f, 48)))
                      for f in (False, True))
    checks = dict(mesh_vs_area=(mesh_rel, 0.15),
                  sphere_path_vs_direct=(sphere_rel, 0.1),
                  bdpt_vs_path_point=(abs(mb - mp) / mp, 0.06),
                  bdpt_vs_path_sun=(abs(sb - sp_) / sp_, 0.08))
    phase("lights_physics", size=f"{r}x{r}",
          **{k_: f"{v:.5f}<{b}" for k_, (v, b) in checks.items()},
          sphere_seen=seen, sun_bdpt_mean=sb, penumbra_width_hard=hard,
          penumbra_width_soft=soft, edge_frac_48_hard=hard48,
          edge_frac_48_soft=soft48, gpu=repr(smi))
    if not (all(v < b for v, b in checks.values()) and seen and sb > 1e-3
            and soft > hard + 0.01 and soft48 > hard48 + 0.01):
        raise AssertionError("lights_physics: a light's physics is off")


def slice18_phases(smi, out_dir: str, kernels: list) -> None:
    """Every light type on cornell_lights.xml: the scene, its dense
    kernels against their plain versions on recorded rays, the path at its
    own settings (and a profiled step), BDPT and photon mapping at full
    width, the card against the CPU under all five integrators and the
    portal room, the reference's light physics at 128², and the CLI.  The
    dense and photon kernels' entries of `kernels` take `*_lights`."""
    scene, cfg, cs = lights_scene()
    chk = lights_kernels(cs, cfg)
    path = lights_path(smi, cs, cfg)
    bidir = lights_bidir(smi)
    photon, dens, near = lights_photon(smi)
    phase("lights_kernels", **{
        what: (f"err={c['err']} ms={round(c['ms'], 4)} "
               f"plain_ms={round(c['plain_ms'], 4)} "
               f"bound_ms={round(c['bound']['bound_ms'], 5)}")
        for what, c in (("closest_primary", chk["closest"]),
                        ("shadow_point", chk["point"]),
                        ("shadow_sun", chk["sun"]),
                        ("density_radiance", dens),
                        ("nearest_final_gather", near))},
        tolerance="closest bit-equal; shadow atol 2e-3 and bit-equal; "
                  "gathers counts equal, values rtol 1e-5")
    lights_card_vs_cpu()
    lights_physics(smi)
    cli_copy("lights_cli", LIGHTS, 64, 64, 16, smi, out_dir)
    by_name = {k["name"]: k for k in kernels}
    updates = {
        DENSE[0]: dict(launches_lights=path[DENSE[0]],
                       launches_lights_bidir=bidir[DENSE[0]],
                       launches_lights_photon=photon[DENSE[0]],
                       ms_lights=chk["closest"]["ms"],
                       plain_ms_lights=chk["closest"]["plain_ms"],
                       bound_ms_lights=chk["closest"]["bound"]["bound_ms"],
                       max_abs_err_lights=chk["closest"]["err"]),
        DENSE[1]: dict(launches_lights=path[DENSE[1]],
                       launches_lights_bidir=bidir[DENSE[1]],
                       launches_lights_photon=photon[DENSE[1]],
                       ms_lights_point=chk["point"]["ms"],
                       plain_ms_lights_point=chk["point"]["plain_ms"],
                       bound_ms_lights_point=chk["point"]["bound"][
                           "bound_ms"],
                       ms_lights_sun=chk["sun"]["ms"],
                       plain_ms_lights_sun=chk["sun"]["plain_ms"],
                       bound_ms_lights_sun=chk["sun"]["bound"]["bound_ms"],
                       max_abs_err_lights=max(chk["point"]["err"],
                                              chk["sun"]["err"])),
        "density_flash": dict(launches_lights_photon=photon["density_flash"],
                              ms_lights=dens["ms"],
                              plain_ms_lights=dens["plain_ms"],
                              bound_ms_lights=dens["bound"]["bound_ms"],
                              max_abs_err_lights=dens["err"]),
        "nearest_flash": dict(launches_lights_photon=photon["nearest_flash"],
                              ms_lights=near["ms"],
                              plain_ms_lights=near["plain_ms"],
                              bound_ms_lights=near["bound"]["bound_ms"],
                              max_abs_err_lights=near["err"]),
    }
    for name, kv in updates.items():
        if name in by_name:  # absent on a run of --only slice18
            by_name[name].update(kv)


# ---- slice 19: cameras, sky backgrounds, volumes, visibility --------------

SKY_FOG = os.path.join(REPO, "scenes", "sky_fog.xml")
SKY_SMALL = dict(width=32, height=32, AA_minsamples=2)
SKY_CLI = dict(size=64, spp=4)
# a point light the light-tracing strategies can start from (the sun and
# the IBL light carry no photon flux): BDPT's t = 1 splats, photon maps
SKY_LAMP = dict(type="pointlight", color=(1.0, 0.9, 0.8), power=60.0,
                **{"from": (0.8, -1.6, 2.4)})
# the card-vs-CPU cameras: field overrides of the scene's thin-lens camera
SKY_CAMERAS = {
    "perspective_dof_hexagon": {},
    "perspective_dof_ring_center": dict(bokeh_type="ring",
                                        bokeh_bias="center"),
    "perspective_dof_triangle_edge": dict(bokeh_type="triangle",
                                          bokeh_bias="edge"),
    "architect_dof": dict(cam_type=1),
    "angular_circular_mirrored": dict(cam_type=2, angle_deg=150.0,
                                      circular=True, mirrored=True),
    "orthographic": dict(cam_type=3, scale=9.0),
    "equirectangular": dict(cam_type=4),
}
# directlighting with an EmissionIntegrator fog on a gradient background
# with its IBL light
GRADIENT_FOG_XML = """<scene type="triangle">
  <material name="m"><type sval="shinydiffusemat"/>
    <color r="0.7" g="0.6" b="0.5"/></material>
  <light name="p"><type sval="pointlight"/>
    <from x="1.0" y="-1.0" z="3.0"/><power fval="6.0"/>
    <color r="1.0" g="1.0" b="1.0"/></light>
  <background name="bg"><type sval="gradient"/>
    <horizon_color r="0.9" g="0.8" b="0.7"/>
    <zenith_color r="0.2" g="0.4" b="0.9"/>
    <horizon_ground_color r="0.5" g="0.45" b="0.4"/>
    <zenith_ground_color r="0.2" g="0.18" b="0.15"/>
    <power fval="1.5"/><ibl bval="true"/><ibl_samples ival="4"/>
  </background>
  <camera name="cam"><type sval="perspective"/>
    <from x="0.5" y="-6.0" z="2.0"/><to x="0.0" y="0.0" z="0.5"/>
    <up x="0.5" y="-6.0" z="3.0"/><resx ival="32"/><resy ival="32"/>
    <focal fval="0.9"/></camera>
  <volumeregion name="v"><type sval="ExpDensityVolume"/>
    <sigma_a fval="0.05"/><sigma_s fval="0.1"/><l_e fval="0.4"/>
    <a fval="1.0"/><b fval="0.7"/>
    <minX fval="-3.0"/><minY fval="-3.0"/><minZ fval="0.0"/>
    <maxX fval="3.0"/><maxY fval="3.0"/><maxZ fval="2.5"/></volumeregion>
  <mesh id="1" vertices="4" faces="2" has_uv="false" type="0">
    <p x="-3" y="-3" z="0"/><p x="3" y="-3" z="0"/><p x="3" y="3" z="0"/>
    <p x="-3" y="3" z="0"/><set_material sval="m"/>
    <f a="0" b="1" c="2"/><f a="0" b="2" c="3"/>
  </mesh>
  <integrator name="default"><type sval="directlighting"/>
    <raydepth ival="2"/></integrator>
  <integrator name="volintegr"><type sval="EmissionIntegrator"/></integrator>
  <render><camera_name sval="cam"/><integrator_name sval="default"/>
    <volintegrator_name sval="volintegr"/>
    <width ival="32"/><height ival="32"/><AA_minsamples ival="2"/>
    <filter_type sval="box"/></render>
</scene>"""
# the reference's object-visibility scene (a floor, an occluder quad between
# it and a point light; tests/test_visibility.py) at 64²
VIS_XML = """<scene type="triangle">
  <material name="white"><type sval="shinydiffusemat"/>
    <color r="0.8" g="0.8" b="0.8"/></material>
  <material name="gray"><type sval="shinydiffusemat"/>
    <color r="0.3" g="0.3" b="0.3"/></material>
  <light name="sun"><type sval="pointlight"/>
    <from x="0.0" y="0.0" z="4.0"/><color r="1.0" g="1.0" b="1.0"/>
    <power fval="80.0"/></light>
  <camera name="cam"><type sval="perspective"/>
    <from x="0.0" y="-6.0" z="3.0"/><to x="0.0" y="0.0" z="0.0"/>
    <up x="0.0" y="-6.0" z="4.0"/><resx ival="64"/><resy ival="64"/>
    <focal fval="1.1"/></camera>
  <background name="bg"><type sval="constant"/>
    <color r="0.0" g="0.0" b="0.0"/></background>
  <mesh id="1" vertices="4" faces="2" has_uv="false" type="0">
    <p x="-4.0" y="-4.0" z="0.0"/><p x="4.0" y="-4.0" z="0.0"/>
    <p x="4.0" y="4.0" z="0.0"/><p x="-4.0" y="4.0" z="0.0"/>
    <set_material sval="white"/><f a="0" b="1" c="2"/><f a="0" b="2" c="3"/>
  </mesh>
  <mesh id="2" vertices="4" faces="2" has_uv="false"{vis} type="0">
    <p x="-1.0" y="-1.0" z="2.0"/><p x="1.0" y="-1.0" z="2.0"/>
    <p x="1.0" y="1.0" z="2.0"/><p x="-1.0" y="1.0" z="2.0"/>
    <set_material sval="gray"/><f a="0" b="1" c="2"/><f a="0" b="2" c="3"/>
  </mesh>
  <integrator name="default"><type sval="directlighting"/>
    <raydepth ival="2"/></integrator>
  <integrator name="volintegr"><type sval="none"/></integrator>
  <render><camera_name sval="cam"/><integrator_name sval="default"/>
    <width ival="64"/><height ival="64"/><AA_passes ival="1"/>
    <AA_minsamples ival="4"/><filter_type sval="box"/></render>
</scene>"""


def sky_scene(render_params=None, integrator=None, camera=None,
              lamp=False, background=None):
    """scenes/sky_fog.xml parsed, with render / integrator parameters, its
    camera's fields replaced by `camera`, SKY_LAMP added (lamp) and its
    background replaced (background: the factory's parameters)."""
    from dataclasses import replace

    scene = scene_at(SKY_FOG, render_params, integrator)
    if camera:
        scene.cameras["cam"] = replace(scene.cameras["cam"], **camera)
    if lamp:
        scene.create_light("lamp", ParamMap(SKY_LAMP))
    if background:
        scene.create_background("sky", ParamMap(background))
    return scene


def sky_step_launches(cs, cfg) -> dict:
    """Each kernel's launches a sample step, from the engine's loops: a
    closest hit at every path vertex (bounces + 1); a shadow batch at every
    vertex for each NEE light that casts shadows, and at each of the fog
    march's MARCH_STEPS steps one for each light the march samples (not
    the meshlights, not the background light)."""
    from libyafaray_tpu_torch.volumes import integrate as vol

    verts = cfg.bounces + 1
    marched = len(vol._marched_lights(cs.static)) * len(cs.static.volumes)
    return {TINY[0]: verts,
            DENSE[1]: verts * nee_lights(cs.static)
            + vol.MARCH_STEPS * marched}


def sky_fog_scene() -> tuple:
    """sky_fog.xml compiled for the card: 26 camera-visible triangles (the
    tiny route) and 334 shadow casters (the dense route), its sky grid
    (uploaded to the card and read back) equal to the host's Preetham
    bake, one ExpDensityVolume.  Returns (scene, config, compiled)."""
    import xml.etree.ElementTree as ET

    from libyafaray_tpu_torch.backgrounds.sky import bake_sky
    from libyafaray_tpu_torch.scene.xml_parser import _parse_params

    t0 = time.perf_counter()
    scene = scene_at(SKY_FOG)
    cfg = build_config(scene)
    cs = scene.compile(device="cuda")
    a, st = cs.arrays, cs.static
    routes = (isect.route(a["tri_pack10"], a["tri_cluster8"],
                          st.n_tris_real),
              isect.route(a["stri_pack10"], a["stri_cluster8"],
                          st.n_stris_real))
    sky_el = next(e for e in ET.parse(SKY_FOG).getroot()
                  if e.tag == "background")
    _, host = bake_sky("sunsky", _parse_params(sky_el))
    card = to_tensors({"bg_image": a["bg_image"]}, "cuda")["bg_image"]
    grid_equal = bool(np.array_equal(card.cpu().numpy(), host))
    vol = st.volumes[0] if st.volumes else None
    phase("sky_scene", visible_tris=st.n_tris_real,
          shadow_tris=st.n_stris_real, routes=routes,
          invisible_excluded=True, sky_grid=tuple(card.shape),
          sky_grid_equal_cpu_bake=grid_equal, ibl_samples=st.bg.ibl_samples,
          lights=[LT_NAMES[ls.ltype] for ls in st.lights],
          fog=(f"type={vol.vtype} box={vol.bmin}..{vol.bmax} "
               f"sigma_a={vol.sigma_a} sigma_s={vol.sigma_s} a={vol.a} "
               f"b={vol.b}" if vol else None),
          vol_integrator=cfg.vol_integrator, camera=(
              f"aperture={cs.camera.aperture} bokeh={cs.camera.bokeh_type} "
              f"dof={cs.camera.dof_distance}"),
          integrator=cfg.integrator, bounces=cfg.bounces,
          size=f"{cfg.width}x{cfg.height}", spp=cfg.aa_samples,
          compile_s=round(time.perf_counter() - t0, 3))
    if routes != ("tiny", "dense") or (st.n_tris_real,
                                       st.n_stris_real) != (26, 334):
        raise AssertionError(f"sky_scene: sets {st.n_tris_real} / "
                             f"{st.n_stris_real} routed {routes}")
    if not grid_equal or vol is None or vol.sigma_s <= 0:
        raise AssertionError("sky_scene: the sky grid differs from the CPU "
                             "bake, or the fog is missing")
    return scene, cfg, cs


def sky_kernels(cs, cfg) -> dict:
    """closest_hit_tiny on one 512² step's recorded primary rays, and
    shadow_logsum_dense on one recorded fog in-scatter batch (march step
    7: the sun's segments of 1e8 from every lane's march point, no dead
    lane), each against its plain version."""
    from libyafaray_tpu_torch.volumes import integrate as vol

    step, arrays = path_step(cs, cfg)
    dev = engine.resolve_device("cuda")
    flags = torch.ones((cfg.height, cfg.width), dtype=torch.bool, device=dev)
    (_, shadow), closest = record_calls(ci, (TINY[0],), lambda: record_calls(
        cx, (DENSE[1],), lambda: step(arrays, _fresh_film(cfg, dev), flags)))
    torch.cuda.synchronize()
    want = sky_step_launches(cs, cfg)
    if len(closest) != want[TINY[0]] or len(shadow) != want[DENSE[1]]:
        raise AssertionError(f"sky_kernels: recorded {len(closest)} / "
                             f"{len(shadow)} calls, expected {want}")
    args = shadow[7][1]  # the march runs before the first vertex's NEE
    dist = args[6]
    if not (bool((dist == 1e8).all())
            and dist.shape[0] == cfg.width * cfg.height
            and vol.MARCH_STEPS > 7):
        raise AssertionError("sky_kernels: the recorded batch is not a fog "
                             "in-scatter batch")
    pk, org, dirn, tmin, tmax, n_tris = closest[0][1]
    out = dict(closest=check_tiny_closest(pk, (org, dirn, tmin, tmax),
                                          n_tris, "sky_fog primary"),
               shadow=check_mid_shadow("dense", args,
                                       "sky_fog in-scatter step 7 (1e8)"))
    del closest, shadow, arrays
    return out


def sky_path(smi, cs, cfg) -> dict:
    """sky_fog.xml at its own settings (pathtracing, bounces 3, 512², 16
    spp, the fog's 16-step march) through render_scene(timed=True),
    counted against sky_step_launches; one profiled step, and one with the
    volume integrator off: the volume layer's launches are the
    difference."""
    scene = scene_at(SKY_FOG)
    res, launches = entry_counted(scene, (TINY[0], DENSE[1]))
    per_step = sky_step_launches(cs, cfg)
    steps = cfg.aa_samples + 1
    path_line("sky_path", res, cfg, launches,
              {k: v * steps for k, v in per_step.items()}, smi,
              spp=cfg.aa_samples, bounces=cfg.bounces,
              launches_per_step=per_step,
              step_ms=round(1e3 * res.stats["render_s"] / cfg.aa_samples,
                            3))
    tags = ("closest_tiny_kernel", "shadow_dense_kernel")
    step, arrays = path_step(cs, cfg)
    prof = profile_step(step, arrays, cfg, tags,
                        {"volume": (engine, "integrate_volume")})
    off = RenderConfig(**{**cfg.__dict__, "vol_integrator": "none"})
    no_fog = profile_step(engine.make_sample_step(
        cs.static, cs.camera, off, engine.resolve_device("cuda")), arrays,
        off, tags)
    step_ms = 1e3 * res.stats["render_s"] / cfg.aa_samples
    busy = prof["device_busy_ms"]
    phase("sky_profile", step_ms=round(step_ms, 3), **prof,
          busy_share=(busy / step_ms if isinstance(busy, float)
                      else "not measured"),
          launches_no_fog=no_fog.get("kernel_launches", "not measured"),
          volume_layer_launches=(
              prof["kernel_launches"] - no_fog["kernel_launches"]
              if "kernel_launches" in prof and "kernel_launches" in no_fog
              else "not measured"),
          busy_ms_no_fog=no_fog["device_busy_ms"], gpu=repr(smi))
    del arrays
    return launches


def sky_card_vs_cpu() -> None:
    """The card against the CPU at 32², 2 spp (PERF.md §2's bounds): the
    scene through every camera (SKY_CAMERAS), under darksky (the Preetham
    stand-in), as BDPT with the architect camera and SKY_LAMP (the t = 1
    density plane on its own), and as photon mapping with the scene's
    depth of field at 16,384 photons; and GRADIENT_FOG_XML (directlighting,
    EmissionIntegrator, gradient IBL)."""
    from libyafaray_tpu_torch.scene.xml_parser import parse_xml_string

    for what, cam in SKY_CAMERAS.items():
        entry_vs_cpu(f"sky_fog {what}", lambda: sky_scene(
            SKY_SMALL, camera=cam), 1e-4, tag="sky_card_vs_cpu")
    entry_vs_cpu("sky_fog darksky", lambda: sky_scene(
        SKY_SMALL, background=dict(
            type="darksky", turbidity=3.0, background_light=True,
            light_samples=8, **{"from": (-0.45, 0.55, 0.7)})), 1e-4,
        tag="sky_card_vs_cpu")
    entry_vs_cpu("sky_fog bidirectional architect_dof", lambda: sky_scene(
        SKY_SMALL, dict(type="bidirectional"), camera=dict(cam_type=1),
        lamp=True), 1e-4, density=1e-5, tag="sky_card_vs_cpu")
    entry_vs_cpu("sky_fog photonmapping dof", lambda: sky_scene(
        SKY_SMALL, dict(type="photonmapping", photons=16_384, cPhotons=8192,
                        fg_samples=4), lamp=True), 1e-3, rays_rel=1e-3,
        stored_rel=1e-3, tag="sky_card_vs_cpu")
    entry_vs_cpu("gradient_fog directlighting emission",
                 lambda: parse_xml_string(GRADIENT_FOG_XML), 1e-4,
                 tag="sky_card_vs_cpu")


def sky_optimize(smi) -> None:
    """SingleScatter `optimize` (attenuation grids baked at render start)
    against the exact march on the reference's own test scene (a point
    light in a UniformVolume box, directlighting raydepth 1; a floor below
    the box, as the port compiles no empty scene) at 64², 4 spp: image
    means within 5% (tests/test_volumes_film.py's bound), and the grids
    taking the march's shadow batches."""
    def make(optimize):
        s = Scene()
        floor = s.create_material("floor", ParamMap(type="shinydiffusemat"))
        s.create_background("bg", ParamMap(type="constant",
                                           color=(0.0, 0.0, 0.0)))
        s.create_light("L", ParamMap(type="pointlight", color=(1.0, 1.0, 1.0),
                                     power=40.0, **{"from": (0.0, 0.0, 2.5)}))
        quad_mesh(s, 1, ((-6, -6, -3), (6, -6, -3), (6, 6, -3), (-6, 6, -3)),
                  floor)
        s.create_volume_region("v", ParamMap(
            type="UniformVolume", sigma_a=0.05, sigma_s=0.25, minX=-2.0,
            maxX=2.0, minY=-2.0, maxY=2.0, minZ=-2.0, maxZ=2.0))
        s.create_integrator("volintegr", ParamMap(
            type="SingleScatterIntegrator", stepSize=0.2, optimize=optimize))
        s = flat_scene(s, "directlighting", 64, 4, {
            "from": (0.0, -5.0, 0.0), "to": (0.0, 0.0, 0.0),
            "up": (0.0, -5.0, 1.0), "focal": 1.0}, raydepth=1)
        s.render_params["volintegrator_name"] = "volintegr"
        return s

    out = {}
    for opt in (False, True):
        res, launches = counted(lambda: render_scene(make(opt),
                                                     device="cuda"))
        out[opt] = (res, launches["shadow_logsum_tiny"])
    exact, opt = out[False][0].image, out[True][0].image
    rel = abs(float(opt.mean()) - float(exact.mean())) / float(exact.mean())
    phase("sky_optimize", size="64x64", spp=4, mean_exact=float(exact.mean()),
          mean_optimize=float(opt.mean()), rel=rel, bound=0.05,
          shadow_launches_exact=out[False][1],
          shadow_launches_optimize=out[True][1],
          rmse=float(np.sqrt(np.mean((opt - exact) ** 2))), gpu=repr(smi))
    if not (np.isfinite(opt).all() and exact.mean() > 1e-3 and rel < 0.05
            and out[True][1] < out[False][1]):
        raise AssertionError("sky_optimize: the attenuation grids disagree "
                             "with the exact march")


def visibility_phase(smi) -> None:
    """The four object-visibility variants of VIS_XML on the card at 64²,
    4 spp (directlighting), held to tests/test_visibility.py's assertions:
    a shadow where the occluder casts, a lit floor where it does not, the
    occluder seen or not, and the same shadow field whether or not the
    camera sees the caster."""
    from libyafaray_tpu_torch.scene.xml_parser import parse_xml_string

    img, sets = {}, {}
    for vis in ("normal", "invisible", "shadow_only", "no_shadows"):
        xml = VIS_XML.format(vis=f' visibility="{vis}"')
        cs = parse_xml_string(xml).compile(device="cuda")
        sets[vis] = (cs.static.n_tris_real, cs.static.n_stris_real)
        img[vis] = render_scene(parse_xml_string(xml), device="cuda").image

    def center(a):
        h, w, _ = a.shape
        return float(a[h // 2 - 4:h // 2 + 4, w // 2 - 4:w // 2 + 4].mean())

    h = img["normal"].shape[0]
    sl = np.s_[h // 2 - 2:h // 2 + 2, h // 2 - 2:h // 2 + 2]
    checks = {
        "normal_shadowed": center(img["normal"]) < 0.05,
        "shadow_only_shadowed": center(img["shadow_only"]) < 0.05,
        "invisible_lit": center(img["invisible"]) > 0.5,
        "no_shadows_lit": center(img["no_shadows"]) > 0.5,
        "shadow_drops_energy": (
            img["shadow_only"].mean() < 0.9 * img["invisible"].mean()
            and img["normal"].mean() < 0.9 * img["no_shadows"].mean()),
        "caster_seen": (
            np.abs(img["normal"] - img["shadow_only"]).max() > 0.05
            and np.abs(img["no_shadows"] - img["invisible"]).max() > 0.05),
        "same_shadow_field": bool(np.allclose(
            img["normal"][sl], img["shadow_only"][sl], atol=1e-5)),
        "sets": sets == {"normal": (4, 4), "invisible": (2, 2),
                         "shadow_only": (2, 4), "no_shadows": (4, 2)},
    }
    phase("visibility", size=f"{h}x{h}", spp=4, sets=sets,
          center={k: round(center(v), 5) for k, v in img.items()},
          checks=checks, gpu=repr(smi))
    if not all(checks.values()):
        raise AssertionError(f"visibility: {checks}")


def slice19_phases(smi, out_dir: str, kernels: list) -> None:
    """Cameras, the sky backgrounds, volumes and object visibility on
    scenes/sky_fog.xml: the scene and its two sets, the tiny closest hit
    and the dense shadow sum against their plain versions on recorded
    rays, the path at its own settings (and a profiled step), the card
    against the CPU under every camera and the other backgrounds and
    integrators, `optimize` against the exact march, the four visibility
    variants, and the CLI.  The closest_hit_tiny and shadow_logsum_dense
    entries of `kernels` take `*_sky`."""
    _, cfg, cs = sky_fog_scene()
    chk = sky_kernels(cs, cfg)
    path = sky_path(smi, cs, cfg)
    sky_card_vs_cpu()
    sky_optimize(smi)
    visibility_phase(smi)
    cli_copy("sky_cli", SKY_FOG, 16, SKY_CLI["size"], SKY_CLI["spp"], smi,
             out_dir)
    by_name = {k["name"]: k for k in kernels}
    for name, c in ((TINY[0], chk["closest"]), (DENSE[1], chk["shadow"])):
        if name in by_name:  # absent on a run of --only slice19
            by_name[name].update(
                launches_sky=path[name], ms_sky=c["ms"],
                plain_ms_sky=c["plain_ms"],
                bound_ms_sky=c["bound"]["bound_ms"], max_abs_err_sky=c["err"])


# ---- slice 20: the film layer -----------------------------------------------


def _plane_check(name: str, got: np.ndarray, want: np.ndarray) -> dict:
    """One pass plane of the card against the CPU's: RMSE and max abs
    against 1e-4 · max(1, |plane|max); the discrete planes (index, shadow,
    toon), where an ulp at a grazing ray or a rounding edge moves a whole
    sample, may instead differ in at most 0.5% of their pixels."""
    scale = max(1.0, float(np.abs(want).max()))
    d = np.abs(got.astype(np.float64) - want)
    rmse = float(np.sqrt(np.mean(d * d)))
    off = int((d.max(axis=-1) > 1e-4 * scale).sum())
    ok = bool(np.isfinite(got).all()) and (rmse <= 1e-4 * scale or (
        name in DISCRETE_PASSES and off <= 0.005 * d.shape[0] * d.shape[1]))
    return dict(rmse=rmse, max_abs=float(d.max()), off=off, ok=ok)


def planes_vs(tag: str, gpu, cpu, extra=None) -> dict:
    """Every pass plane and alpha of two renders of one config (card, CPU),
    and their images and rays: a phase line; raises on any disagreement."""
    checks = {name: _plane_check(name, gpu.passes[name], cpu.passes[name])
              for name in cpu.cfg.passes}
    if cpu.alpha is not None:
        checks["alpha"] = _plane_check("alpha", gpu.alpha[..., None],
                                       cpu.alpha[..., None])
    rmse = float(np.sqrt(np.mean((gpu.image - cpu.image) ** 2)))
    bad = sorted(k for k, v in checks.items() if not v["ok"])
    worst = max(checks, key=lambda k: checks[k]["rmse"])
    phase(tag, planes=len(checks), image_rmse=rmse, bound=1e-4,
          rays_gpu=gpu.stats["rays"], rays_cpu=cpu.stats["rays"],
          worst=f"{worst}:{checks[worst]['rmse']:.3e}",
          off_pixels={k: v["off"] for k, v in checks.items() if v["off"]},
          failed=bad, **(extra or {}))
    if bad or rmse > 1e-4 or gpu.stats["rays"] != cpu.stats["rays"]:
        raise AssertionError(f"{tag}: card and CPU planes disagree: {bad}")
    return checks


def passes_scene(smi) -> tuple:
    """ibl_passes.xml parsed and compiled for the card: its assets loaded
    from their files (as [ibl_path] asserts), its 28 passes, bg_transp and
    bg_transp_refract.  Returns (scene, config, compiled scene)."""
    scene = scene_at(IBL_PASSES)
    cfg = build_config(scene)
    cs = scene.compile(device="cuda")
    assets = check_assets(cs)
    phase("passes_scene", passes=len(cfg.passes),
          bg_transp=cfg.transp_background,
          bg_transp_refract=cfg.bg_transp_refract, assets=assets,
          size=f"{cfg.width}x{cfg.height}", spp=cfg.aa_samples,
          bounces=cfg.bounces, ao_samples=cfg.ao_samples)
    if not (len(cfg.passes) == 28 and set(cfg.passes) <= set(PASS_NAMES)
            and cfg.transp_background and cfg.bg_transp_refract):
        raise AssertionError("passes_scene: the scene's passes or alpha "
                             "did not parse")
    return scene, cfg, cs


def passes_launches(cfg) -> dict:
    """The tiny kernels' launches in one step of the IBL path with the AO
    pass: a closest hit a vertex, an NEE shadow batch a vertex and one AO
    batch at the first."""
    return {TINY[0]: cfg.bounces + 1, TINY[1]: cfg.bounces + 2}


def _mask_mean(plane, mask) -> float:
    return float(plane[mask].mean()) if mask.any() else float("nan")


def passes_path(smi, scene, cfg, cs) -> tuple:
    """ibl_passes.xml at its own settings (512², 64 spp, bounces 5)
    through render_scene, counted, no warm-up (its film keeps the planes):
    every plane finite, the semantics of the reference's test_passes.py
    and test_alpha.py (shadow in [0, 1], ao-clay grey, alpha 0 on the
    environment, 1 on the floor, below 1 through the glass with
    bg_transp_refract).  Returns (result, launches)."""
    res, launches = counted(lambda: render_scene(scene, device="cuda"))
    others = {k: v for k, v in launches.items() if k not in TINY and v}
    if others:
        raise AssertionError(f"kernels off the path launched: {others}")
    launches = {k: launches[k] for k in TINY}
    per_step = passes_launches(cfg)
    want = {k: v * cfg.aa_samples for k, v in per_step.items()}
    planes, alpha = res.passes, res.alpha
    mats = scene.material_names
    idx = planes["mat-index-abs"][..., 0]
    z = planes["z-depth-abs"][..., 0]
    env = z == 0.0
    floor = idx == float(mats["floor"])
    glass = idx == float(mats["glass"])
    sh, clay = planes["shadow"], planes["ao-clay"]
    checks = {
        "finite": all(np.isfinite(p).all() for p in planes.values())
        and bool(np.isfinite(alpha).all()),
        "planes": len(planes) == 28,
        "shadow_in_0_1": bool(sh.min() >= -1e-6 and sh.max() <= 1 + 1e-6),
        "ao_clay_grey": bool(np.allclose(clay[..., 0], clay[..., 1])
                             and np.allclose(clay[..., 1], clay[..., 2])),
        "alpha_env_0": bool(env.any() and np.median(alpha[env]) == 0.0
                            and _mask_mean(alpha, env) < 0.05),
        "alpha_floor_1": bool(floor.any() and np.median(alpha[floor]) == 1.0
                              and _mask_mean(alpha, floor) > 0.95),
        "alpha_glass_below_1": bool(glass.any()
                                    and _mask_mean(alpha, glass) < 0.9),
        "refract_lit": float(planes["refract"].max()) > 0.0,
        "reflect_lit": float(planes["reflect"].max()) > 0.0,
    }
    path_line("passes_path", res, cfg, launches, want, smi,
              spp=cfg.aa_samples, bounces=cfg.bounces,
              launches_per_step=per_step,
              step_ms=round(1e3 * res.stats["render_s"] / cfg.aa_samples,
                            3),
              alpha_env=_mask_mean(alpha, env),
              alpha_floor=_mask_mean(alpha, floor),
              alpha_glass=_mask_mean(alpha, glass),
              pixels=dict(env=int(env.sum()), floor=int(floor.sum()),
                          glass=int(glass.sum())), checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"passes_path: {checks}")
    return res, launches


def passes_film(cfg, dev) -> dict:
    """A fresh film with the config's alpha and pass planes."""
    return film_add_passes(_fresh_film(cfg, dev, with_alpha=True),
                           cfg.height, cfg.width, cfg.passes, dev)


def passes_profile(smi, res, cs, cfg) -> None:
    """One step of the IBL path profiled with every pass and alpha on, and
    one with the plain film: launches, busy ms and share of each, and the
    film layer's added launches (at most 2,000 a step)."""
    step, arrays = path_step(cs, cfg)
    dev = engine.resolve_device("cuda")
    step_ms = 1e3 * res.stats["render_s"] / cfg.aa_samples
    on = profile_step(step, arrays, cfg, ("tiny_kernel",),
                      film=lambda: passes_film(cfg, dev))
    off = profile_step(step, arrays, cfg, ("tiny_kernel",))
    added = on["kernel_launches"] - off["kernel_launches"]
    busy = {k: v["device_busy_ms"] for k, v in (("on", on), ("off", off))}
    phase("passes_profile", step_ms=round(step_ms, 3),
          launches_on=on["kernel_launches"],
          launches_off=off["kernel_launches"], film_layer_launches=added,
          bound=2000, busy_ms_on=busy["on"], busy_ms_off=busy["off"],
          busy_share_on=(busy["on"] / step_ms
                         if isinstance(busy["on"], float)
                         else "not measured"),
          ported_by_kernel_on=on["ported_by_kernel"],
          top_ops_on=on["top_ops"], gpu=repr(smi))
    if added > 2000:
        raise AssertionError(f"passes_profile: the film layer adds {added} "
                             "launches a step (> 2,000)")


def passes_card_vs_cpu():
    """Every pass plane and alpha, card against CPU, at 32², 4 spp:
    ibl_passes.xml; cornell.xml as pathtracing with the same 28 passes;
    ibl_passes.xml at spp_batch 4; cornell.xml with the passes and alpha
    over 3 adaptive passes (4 + 2 spp, threshold 0.3: compact), the card's
    compact films and planes bit-equal to its dense ones; and BDPT's
    first-hit planes on cornell_bidir.xml."""
    size, spp = PASSES_SMALL["size"], PASSES_SMALL["spp"]
    passes = " ".join(build_config(scene_at(IBL_PASSES)).passes)
    rp = dict(width=size, height=size, AA_minsamples=spp)
    cornell_passes = dict(render_passes=passes, bg_transp=True)
    adaptive = dict(cornell_passes, AA_passes=3, AA_inc_samples=2,
                    AA_threshold=0.3)
    integ = dict(type="pathtracing", bounces=4)
    bd = dict(render_passes="z-depth-abs normal-smooth normal-geom uv "
              "mat-index-abs obj-index-abs diffuse-color")
    scenes = [scene_at(IBL_PASSES, rp),
              scene_at(CORNELL, dict(rp, **cornell_passes), integ),
              scene_at(CORNELL, dict(rp, **adaptive), integ),
              scene_at(BIDIR, dict(rp, **bd))]
    batch4 = photon_scene(IBL_PASSES, "cpu", size=size, aa_samples=spp,
                          spp_batch=4)
    cpu = yield ([(render_scene, (sc,), dict(device="cpu"))
                  for sc in scenes]
                 + [(render, batch4, dict(device="cpu"))])
    gpu = [render_scene(sc, device="cuda") for sc in scenes]
    gpu.append(render(*photon_scene(IBL_PASSES, "cuda", size=size,
                                    aa_samples=spp, spp_batch=4),
                      device="cuda"))
    planes_vs("passes_card_vs_cpu", gpu[0], cpu[0],
              extra=dict(scene="ibl_passes", size=f"{size}x{size}", spp=spp))
    planes_vs("passes_card_vs_cpu", gpu[1], cpu[1],
              extra=dict(scene="cornell", size=f"{size}x{size}", spp=spp))
    planes_vs("passes_card_vs_cpu", gpu[4], cpu[4],
              extra=dict(scene="ibl_passes", spp_batch=4,
                         size=f"{size}x{size}", spp=spp))
    dense = render_scene(scenes[2], device="cuda", compact=False)
    modes = [e["mode"] for e in gpu[2].stats["pass_log"]]
    equal = set(gpu[2].film) == set(dense.film) and all(
        torch.equal(gpu[2].film[k], dense.film[k]) for k in gpu[2].film)
    planes_vs("passes_card_vs_cpu", gpu[2], cpu[2], extra=dict(
        scene="cornell", adaptive_passes=3, modes=modes,
        compact_equals_dense=equal, size=f"{size}x{size}", spp=spp))
    if not (equal and "compact" in modes):
        raise AssertionError("passes_card_vs_cpu: compact passes disagree "
                             "with dense ones")
    planes_vs("passes_card_vs_cpu", gpu[3], cpu[3],
              extra=dict(scene="cornell_bidir", size=f"{size}x{size}",
                         spp=spp))


class Killed(Exception):
    pass


def kill_and_resume(run, path: str, kill_at: int):
    """run(film_path, progress_cb) stopped by its callback after pass
    (step) kill_at, so the film of the pass before it is on disk, then run
    again from that film.  Returns the resumed result."""
    def kill(p, total):
        if p == kill_at:
            raise Killed

    try:
        run(path, kill)
    except Killed:
        pass
    else:
        raise AssertionError("kill_and_resume: the render was not stopped")
    saved = int(np.load(path)["__pass__"])
    if saved != kill_at - 1:
        raise AssertionError(f"kill_and_resume: saved pass {saved}")
    return run(path, None)


def film_resume(smi, out_dir: str) -> None:
    """On the card at 32²: the path tracer (3 adaptive passes, with pass
    and alpha planes), photon mapping (2 passes), SPPM (4 passes, 16,384
    photons) and BDPT (3 steps) stopped after a pass and resumed under
    load-save, against the same render straight through: every film plane
    equal (BDPT: the eye planes equal, density RMSE <= 1e-5); and a
    time-autosave file written mid-pass."""
    size = FILM_RESUME["size"]
    rows = {}

    def case(tag, path, rp, integ, kill_at, skip=()):
        rp = dict(width=size, height=size, film_save_load="load-save",
                  **rp)
        straight = render_scene(scene_at(path, rp, integ), device="cuda")
        film = os.path.join(out_dir, f"{tag}.npz")
        resumed = kill_and_resume(lambda f, cb: render_scene(
            scene_at(path, rp, integ), device="cuda", film_path=f,
            progress_cb=cb), film, kill_at)
        equal = set(straight.film) == set(resumed.film) and all(
            torch.equal(straight.film[k], resumed.film[k])
            for k in straight.film if k not in skip)
        d = [float(torch.sqrt(torch.mean(
            (straight.film[k] - resumed.film[k]) ** 2))) for k in skip]
        rows[tag] = dict(equal=equal, rmse=max(d, default=0.0),
                         planes=len(straight.film))
        return equal and all(x <= 1e-5 for x in d)

    ok = [
        case("render", CORNELL, dict(
            AA_minsamples=4, AA_passes=3, AA_inc_samples=2,
            AA_threshold=0.3, bg_transp=True,
            render_passes="z-depth-abs direct ao reflect"),
            dict(type="pathtracing", bounces=4), 2),
        case("photon", PHOTON, dict(AA_minsamples=2, AA_passes=2,
                                    AA_inc_samples=1),
             dict(photons=16_384, cPhotons=8_192, fg_samples=4), 2),
        case("sppm", CORNELL_SPPM, {}, dict(passNums=4, photons=16_384), 3),
        case("bdpt", BIDIR, dict(AA_minsamples=3,
                                 render_passes="z-depth-abs normal-smooth"),
             None, 2, skip=("density",)),
    ]
    auto = os.path.join(out_dir, "auto.npz")
    render_scene(scene_at(CORNELL, dict(
        width=size, height=size, AA_minsamples=2, AA_passes=2,
        AA_inc_samples=1, images_autosave_interval_type="time",
        images_autosave_interval_seconds=0.0)), device="cuda",
        film_path=auto)
    auto_pass = int(np.load(auto)["__pass__"]) if os.path.exists(auto) \
        else None
    phase("film_resume", size=f"{size}x{size}", cases=rows,
          time_autosave_pass=auto_pass, density_bound=1e-5, gpu=repr(smi))
    if not (all(ok) and auto_pass == 1):
        raise AssertionError(f"film_resume: {rows}, autosave {auto_pass}")


def passes_cli(smi, out_dir: str) -> None:
    """The CLI on ibl_passes.xml at 64², 4 spp to a multilayer .exr, read
    back with the port's reader: every layer equal to its render_scene
    call's pass (the combined image, alpha), rays equal; cornell.xml with
    -z to a PNG (its .z-depth-norm.png the 8-bit of the call's pass); and
    --film with load-save run twice (the second loads the finished film,
    runs no pass, and writes the same image and rays)."""
    from libyafaray_tpu_torch.io.exr import read_exr_multilayer
    from libyafaray_tpu_torch.io.image import read_png
    from libyafaray_tpu_torch.scene import session

    size, spp = PASSES_CLI["size"], PASSES_CLI["spp"]
    xml = os.path.join(out_dir, "passes_cli.xml")
    with open(IBL_PASSES) as f:
        text = f.read()
    with open(xml, "w") as f:
        f.write(text.replace('<AA_minsamples ival="64"/>',
                             f'<AA_minsamples ival="{spp}"/>'))
    real, results = session.render_scene, []

    def recorded(*args, **kwargs):
        results.append(real(*args, **kwargs))
        return results[-1]

    def cli(args):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(args + ["--json-stats", "-vl", "warning",
                                  "--width", str(size), "--height",
                                  str(size)])
        stats = json.loads([line for line in buf.getvalue().splitlines()
                            if line.startswith("{")][-1])
        return rc, stats

    session.render_scene = recorded
    try:
        out = os.path.join(out_dir, "passes_cli.exr")
        rc, stats = cli([xml, out])
        layers = read_exr_multilayer(out)
        res = results[-1]
        want = dict(res.passes, alpha=res.alpha[..., None])
        want[""] = res.image
        layers_equal = set(layers) == set(want) and all(
            np.array_equal(layers[k], want[k]) for k in want)
        # -z to a PNG
        zxml = os.path.join(out_dir, "z.xml")
        with open(CORNELL) as f:
            ztext = f.read()
        with open(zxml, "w") as f:
            f.write(ztext.replace('<AA_minsamples ival="64"/>',
                                  f'<AA_minsamples ival="{spp}"/>'))
        zout = os.path.join(out_dir, "z.png")
        zrc, _ = cli([zxml, zout, "-z"])
        zres = results[-1]
        zfile = os.path.join(out_dir, "z.z-depth-norm.png")
        z8 = (np.clip(zres.passes["z-depth-norm"], 0, 1) * 255 + 0.5).astype(
            np.uint8)[..., 0]
        z_ok = (zrc == 0 and zres.cfg.passes == ("z-depth-norm",)
                and os.path.exists(zfile)
                and np.array_equal(read_png(zfile)[..., 0], z8))
        # --film: load-save twice
        fxml = os.path.join(out_dir, "film.xml")
        with open(fxml, "w") as f:
            f.write(ztext.replace('<AA_minsamples ival="64"/>',
                                  f'<AA_minsamples ival="{spp}"/>').replace(
                "</render>", '<film_save_load sval="load-save"/></render>'))
        film = os.path.join(out_dir, "cli_film.npz")
        runs = []
        for k in range(2):
            fout = os.path.join(out_dir, f"film{k}.exr")
            frc, fstats = cli([fxml, fout, "--film", film])
            runs.append((frc, fstats["rays"], read_exr(fout),
                         os.stat(film).st_mtime_ns))
        film_ok = (runs[0][0] == runs[1][0] == 0 and runs[0][1] == runs[1][1]
                   and np.array_equal(runs[0][2], runs[1][2])
                   and runs[0][3] == runs[1][3])
    finally:
        session.render_scene = real
    phase("passes_cli", rc=rc, size=f"{size}x{size}", spp=spp,
          layers=len(layers), layers_equal=layers_equal,
          rays=stats["rays"], rays_render_scene=res.stats["rays"],
          wall_s=round(stats["wall_s"], 4),
          render_s=round(stats["render_s"], 4), z_png=z_ok,
          film_resume=film_ok, gpu=repr(smi))
    if not (rc == 0 and layers_equal and len(layers) == 30
            and stats["rays"] == res.stats["rays"] and z_ok and film_ok):
        raise AssertionError("passes_cli: the CLI's output disagrees with "
                             "its render")


def denoise_phase(smi, image: np.ndarray) -> None:
    """nlm_denoise of the [passes_path] image (512²) on the card against
    the CPU: max abs within 1e-5 · max(1, |image|max)."""
    from libyafaray_tpu_torch.film.denoise import nlm_denoise

    x = torch.from_numpy(np.ascontiguousarray(image))
    gpu, ms = once_ms(lambda: nlm_denoise(x.cuda()))
    gpu = gpu.cpu().numpy()
    cpu = nlm_denoise(x).numpy()
    scale = max(1.0, float(np.abs(cpu).max()))
    err = float(np.abs(gpu - cpu).max())
    phase("denoise", size=f"{image.shape[0]}x{image.shape[1]}",
          ms=round(ms, 3), max_abs_err=err, bound=1e-5 * scale,
          smoothed=float(np.abs(np.diff(cpu, axis=1)).mean())
          < float(np.abs(np.diff(image, axis=1)).mean()), gpu=repr(smi))
    if not (np.isfinite(gpu).all() and err <= 1e-5 * scale):
        raise AssertionError("denoise: card and CPU disagree")


def slice20_phases(smi, out_dir: str, kernels: list) -> None:
    """The film layer on scenes/ibl_passes.xml: the scene, the path with
    every pass and alpha at its own settings, a step profiled with the
    planes on and off, the planes card against CPU (and compact against
    dense), film resume under four integrators, the CLI, and the denoise.
    The tiny kernels' entries of `kernels` take `launches_passes`."""
    scene, cfg, cs = passes_scene(smi)
    res, launches = passes_path(smi, scene, cfg, cs)
    passes_profile(smi, res, cs, cfg)
    defer(passes_card_vs_cpu())
    film_resume(smi, out_dir)
    passes_cli(smi, out_dir)
    denoise_phase(smi, res.image)
    by_name = {k["name"]: k for k in kernels}
    for name in TINY:
        if name in by_name:  # absent on a run of --only slice20
            by_name[name]["launches_passes"] = launches[name]


# ---- slice 21: smoothing, instances, rough glass, dispersion ---------------

SURFACES = os.path.join(REPO, "scenes", "cornell_surfaces.xml")
SURFACES_SMALL = dict(width=32, height=32, AA_minsamples=4)
SURFACES_CLI = dict(size=64, spp=16)
# the reference's rough-glass white furnace (tests/test_integrators.py:226)
FURNACE = dict(res=24, spp=48, bound=0.05)


def surfaces_scene(smi) -> tuple:
    """cornell_surfaces.xml compiled for the card: its triangles before and
    after the two instances, its clusters and routes (dense: < 4 clusters
    of 128), and the corners of the smoothed cylinder that <smooth> rounded
    and that its angle left sharp.  Returns (scene, config, compiled)."""
    from libyafaray_tpu_torch.scene.mesh import finalize_mesh

    t0 = time.perf_counter()
    scene = scene_at(SURFACES)
    cfg = build_config(scene)
    cs = scene.compile(device="cuda")
    a, st = cs.arrays, cs.static
    routes = (isect.route(a["tri_pack10"], a["tri_cluster8"],
                          st.n_tris_real),
              isect.route(a["stri_pack10"], a["stri_cluster8"],
                          st.n_stris_real))
    meshes = {mid: finalize_mesh(m) for mid, m in scene.meshes.items()}
    smooth = [mid for mid, m in scene.meshes.items()
              if m.smooth_angle is not None]
    rounded = sharp = 0
    for mid in smooth:
        b = meshes[mid]
        off = np.abs(np.einsum("tkc,tc->tk", b["normal"], b["geo_n"])
                     - 1.0) > 1e-6
        rounded, sharp = rounded + int(off.sum()), sharp + int((~off).sum())
    before = sum(b["pos"].shape[0] for b in meshes.values())
    inst = sum(b["pos"].shape[0] for b in scene.extra_tri_blocks)
    lamps = st.n_tris_real - before - inst
    phase("surface_scene", tris_meshes=before, tris_instances=inst,
          tris_lamps=lamps, tris=st.n_tris_real, instances=len(
              scene.extra_tri_blocks),
          clusters=a["tri_cluster8"].shape[1], routes=routes,
          smoothed_mesh=smooth, smooth_angle=[scene.meshes[m].smooth_angle
                                              for m in smooth],
          corners_rounded=rounded, corners_sharp=sharp,
          families=list(st.mat_families), dispersion=st.dispersion,
          spheres=st.n_spheres, lights=[LT_NAMES[ls.ltype]
                                        for ls in st.lights],
          integrator=cfg.integrator, bounces=cfg.bounces,
          size=f"{cfg.width}x{cfg.height}", spp=cfg.aa_samples,
          compile_s=round(time.perf_counter() - t0, 3), gpu=repr(smi))
    if routes != ("dense", "dense") or not 64 < st.n_tris_real <= 384:
        raise AssertionError(f"surface_scene: {st.n_tris_real} triangles "
                             f"routed {routes}")
    if not (rounded and sharp and inst and st.dispersion
            and 5 in st.mat_families):  # MT_ROUGH_GLASS
        raise AssertionError("surface_scene: smoothing, the instances, the "
                             "rough glass or the dispersion is missing")
    return scene, cfg, cs


def surfaces_kernels(cs, cfg) -> dict:
    """The dense kernels against their plain versions on one 512² step's
    recorded calls: the primary rays and the prism lamp's bounce-0 NEE
    batch."""
    _, _, calls = step_calls(cs, cfg, cx, DENSE)
    out = dict(closest=check_mid_closest("dense", calls[DENSE[0]][0],
                                         "surfaces primary"),
               shadow=check_mid_shadow("dense", calls[DENSE[1]][1],
                                       "surfaces bounce-0 NEE prism lamp"))
    del calls
    return out


def surfaces_path(smi, cs, cfg) -> dict:
    """cornell_surfaces.xml at its own settings (pathtracing, bounces 5,
    512², 16 spp) through render_scene(timed=True), counted: per step a
    closest hit per vertex and a shadow batch per vertex and lamp, the
    warm-up step included, nothing else; one profiled step."""
    res, launches = entry_counted(scene_at(SURFACES), DENSE)
    verts = cfg.bounces + 1
    per_step = {DENSE[0]: verts, DENSE[1]: verts * nee_lights(cs.static)}
    steps = cfg.aa_samples + 1
    path_line("surface_path", res, cfg, launches,
              {k: v * steps for k, v in per_step.items()}, smi,
              spp=cfg.aa_samples, bounces=cfg.bounces,
              launches_per_step=per_step,
              step_ms=round(1e3 * res.stats["render_s"] / cfg.aa_samples,
                            3))
    profile("surface_profile", res, *path_step(cs, cfg), cfg,
            ("closest_dense_kernel", "shadow_dense_kernel"), smi)
    return launches


def surfaces_card_vs_cpu() -> None:
    """The card against the CPU at 32², 4 spp within PERF.md §2's bounds:
    pathtracing and directlighting (1e-4, rays within 0.01%), BDPT (1e-4,
    rays equal, its density layer 1e-5) and photon mapping (2 spp, 16,384
    photons: 1e-3, rays and stored photons within 0.1%)."""
    for integ in ("pathtracing", "directlighting"):
        entry_vs_cpu("cornell_surfaces", lambda: scene_at(
            SURFACES, SURFACES_SMALL, dict(type=integ)), 1e-4,
            tag="surface_card_vs_cpu")
    entry_vs_cpu("cornell_surfaces", lambda: scene_at(
        SURFACES, SURFACES_SMALL, dict(type="bidirectional")), 1e-4,
        tag="surface_card_vs_cpu", density=1e-5, rays_rel=0.0)
    entry_vs_cpu("cornell_surfaces", lambda: scene_at(
        SURFACES, dict(SURFACES_SMALL, AA_minsamples=2), dict(
            type="photonmapping", photons=16_384, cPhotons=8192,
            fg_samples=4)), 1e-3, tag="surface_card_vs_cpu", rays_rel=1e-3,
        stored_rel=1e-3)


def rough_glass_furnace(smi) -> None:
    """tests/test_integrators.py's white furnace on the card: a lossless
    rough-glass sphere (IOR 1.5, alpha 0.35) in a uniform 0.5 environment
    with its IBL light, pathtracing, bounces 6, 24², 48 spp: the mean of
    |pixel - 0.5| under 0.05."""
    s = Scene()
    s.create_material("m", ParamMap({
        "type": "rough_glass", "IOR": 1.5, "alpha": 0.35,
        "filter_color": (1.0, 1.0, 1.0), "mirror_color": (1.0, 1.0, 1.0)}))
    s.create_background("bg", ParamMap({
        "type": "constant", "color": (0.5, 0.5, 0.5), "ibl": True,
        "ibl_samples": 4}))
    s.add_sphere((0.0, 0.0, 0.0), 1.0, "m")
    flat_scene(s, "pathtracing", FURNACE["res"], FURNACE["spp"], {
        "from": (0.0, -4.0, 0.0), "to": (0.0, 0.0, 0.0),
        "up": (0.0, -4.0, 1.0), "focal": 1.8}, bounces=6, raydepth=6,
        path_samples=1)
    res = render_scene(s, device="cuda")
    err = float(np.abs(res.image - 0.5).mean())
    phase("rough_glass_furnace", size=f"{FURNACE['res']}x{FURNACE['res']}",
          spp=FURNACE["spp"], mean=float(res.image.mean()),
          mean_abs_err=err, bound=FURNACE["bound"], rays=res.stats["rays"],
          gpu=repr(smi))
    if not (np.isfinite(res.image).all() and err < FURNACE["bound"]):
        raise AssertionError(f"rough_glass_furnace: mean |pixel - 0.5| "
                             f"{err} >= {FURNACE['bound']}")


def dispersion_phase(smi) -> None:
    """tests/test_dispersion_cameras.py:26 on the card: chromatic lanes
    through a dispersive glass (power 0.01) at 45 degrees draw wavelengths
    in [0, 1] where it transmits them, the refracted direction spreads with
    the wavelength, wl_to_rgb averages to white within 0.15, and a
    non-dispersive glass keeps every lane chromatic."""
    from libyafaray_tpu_torch.core.color import wl_to_rgb
    from libyafaray_tpu_torch.materials import base as mbase
    from libyafaray_tpu_torch.materials import bsdf
    from libyafaray_tpu_torch.materials.factory import \
        material_row_from_params

    n, dev = 4096, torch.device("cuda")

    def glass(power):
        row = material_row_from_params(ParamMap({
            "type": "glass", "IOR": 1.55, "dispersion_power": power,
            "filter_color": (1.0, 1.0, 1.0)}), {}, {}, {})
        table = to_tensors(mbase.build_material_table([row]), dev)
        return mbase.gather_rows(table, torch.zeros(n, dtype=torch.long,
                                                    device=dev))

    rng = np.random.default_rng(5)
    nrm = torch.tensor([[0.0, 0.0, 1.0]], device=dev).expand(n, 3)
    wo = torch.tensor([[np.sqrt(0.5), 0.0, np.sqrt(0.5)]],
                      dtype=torch.float32, device=dev).expand(n, 3)
    u1, u2, ul = (torch.from_numpy(rng.random(n).astype(np.float32)).to(dev)
                  for _ in range(3))
    wl = torch.full((n,), -1.0, device=dev)
    fam = (mbase.MT_GLASS,)
    smp = bsdf.sample_bsdf(glass(0.01), nrm, nrm, wo, u1, u2, ul, fam, wl)
    tr = (smp["transmit"] & smp["valid"]).cpu().numpy()
    new_wl = smp["new_wavelength"].cpu().numpy()
    wi = smp["wi"].cpu().numpy()
    lo, hi = tr & (new_wl < 0.2), tr & (new_wl > 0.8)
    spread = float(abs(wi[lo, 0].mean() - wi[hi, 0].mean()))
    mean_rgb = wl_to_rgb(torch.linspace(0.0, 1.0, 2048, device=dev)).mean(0)
    smp0 = bsdf.sample_bsdf(glass(0.0), nrm, nrm, wo, u1, u2, ul, fam, wl)
    chromatic = bool((smp0["new_wavelength"] < 0.0).all())
    ok = (tr.sum() > n // 4 and (new_wl[tr] >= 0.0).all()
          and (new_wl[tr] <= 1.0).all() and lo.sum() > 50 and hi.sum() > 50
          and spread > 1e-4
          and bool((torch.abs(mean_rgb - 1.0) < 0.15).all()) and chromatic)
    phase("dispersion", lanes=n, transmitted=int(tr.sum()),
          blue_end=int(lo.sum()), red_end=int(hi.sum()), spread=spread,
          mean_rgb=[round(float(x), 4) for x in mean_rgb],
          plain_glass_chromatic=chromatic, gpu=repr(smi))
    if not ok:
        raise AssertionError("dispersion: the reference's assertions fail "
                             "on the card")


def slice21_phases(smi, out_dir: str, kernels: list) -> None:
    """The rest of the surface on cornell_surfaces.xml: the scene (smoothing
    and instances), its dense kernels against their plain versions on
    recorded rays, the path at its own settings (and a profiled step), the
    card against the CPU under four integrators, the CLI, the rough-glass
    furnace and the dispersion sampler.  The dense kernels' entries of
    `kernels` take `*_surfaces`."""
    scene, cfg, cs = surfaces_scene(smi)
    chk = surfaces_kernels(cs, cfg)
    launches = surfaces_path(smi, cs, cfg)
    surfaces_card_vs_cpu()
    cli_copy("surface_cli", SURFACES, 16, SURFACES_CLI["size"],
             SURFACES_CLI["spp"], smi, out_dir)
    rough_glass_furnace(smi)
    dispersion_phase(smi)
    by_name = {k["name"]: k for k in kernels}
    for name, c in zip(DENSE, (chk["closest"], chk["shadow"])):
        if name in by_name:  # absent on a run of --only slice21
            by_name[name].update(
                launches_surfaces=launches[name], ms_surfaces=c["ms"],
                plain_ms_surfaces=c["plain_ms"],
                bound_ms_surfaces=c["bound"]["bound_ms"],
                max_abs_err_surfaces=c["err"])


# ---- slice 22: scenes above 2^20 triangles, the EXR codecs, the flat API


BVH = ("closest_hit_bvh", "shadow_logsum_bvh")
# the generated grid-spheres scene at 2.5 x MAX_TRIS (the generator's default
# layout two subdivisions finer), at the grid phases' 4 spp
BVH_GRID = dict(grid=8, subdiv=5, spp=4, tris=2_621_452)
# rays of a plain walk on the card: ~650 lockstep steps of ~200 small ops
# whatever the lane count, so a few seconds a call
BVH_PLAIN_LANES = 4096
BVH_SMALL = dict(size=16, spp=1)
BVH_REPLACES = "libyafaray_tpu/ops/bvh_traverse.py:{}"
# bytes a walk needs of each node and triangle it touches, in any layout: a
# node's box (24 B), its next index and its leaf's range (8 B); a triangle's
# v0 | e1 | e2 (36 B) and its index (4 B); a shadow walk's filter row (16 B).
# The packed rows' 8 B of padding a triangle carry nothing and are not
# counted.
NODE_BYTES = 32
TRI_BYTES = 40
LF4_BYTES = 16
# a node visit's box test (bvh_walk.cu node_entered, the reference's
# _aabb_hit), which is not the clustered kernels' widened one: per axis 2
# sub, 2 mul, 1 min, 1 max; 3 max for the entry, 3 min for the exit and 1
# compare.  The closest walk adds 1 min for min(tmax, best_t).
BVH_BOX_OPS = 25
# the clustered kernels' tables, which the BVH route does not build
CLUSTERED_KEYS = ("tris", "tri_pack10", "tri_cluster8", "stri_pack10",
                  "stri_cluster8", "tri_sub8", "stri_sub8", "tri_box32",
                  "stri_box32", "sfilt4", "sfilt4_binary")
EXR_IBL = dict(size=64, spp=4, tiles=(16, 16),
               codecs=(("none", {}), ("zips", {}), ("piz", {}),
                       ("zips_tiled", {"tiles": (16, 16)})))
INTERFACE = dict(size=64, spp=4, cli_size=32)


def bvh_scene(smi, out_dir: str) -> tuple:
    """The generated 2,621,452-triangle grid-spheres scene compiled for the
    card: the BVH route, its BVH built by the native builder (a numpy
    build of 2.6M triangles takes minutes), the shadow set's BVH aliasing
    the visible set's, the clustered kernels' box tables skipped.
    Returns (scene, config, compiled, tensors)."""
    t0 = time.perf_counter()
    path = write_grid_spheres(os.path.join(out_dir, "grid8_5.xml"),
                              BVH_GRID["grid"], BVH_GRID["subdiv"],
                              BVH_GRID["spp"])
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scene = parse_xml_file(path)
    cfg = build_config(scene)
    parse_s = time.perf_counter() - t0
    builds, packs = [], []
    real, real_pack = scene_mod.build_bvh, scene_mod.pack_bvh

    def timed_build(*args, **kwargs):
        t = time.perf_counter()
        out = real(*args, **kwargs)
        builds.append((time.perf_counter() - t, bvh_mod.last_builder))
        return out

    def timed_pack(*args, **kwargs):
        t = time.perf_counter()
        out = real_pack(*args, **kwargs)
        packs.append(time.perf_counter() - t)
        return out

    t0 = time.perf_counter()
    scene_mod.build_bvh, scene_mod.pack_bvh = timed_build, timed_pack
    try:
        cs = scene.compile(device="cuda")
    finally:
        scene_mod.build_bvh, scene_mod.pack_bvh = real, real_pack
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    arrays = to_tensors(cs.arrays, "cuda")
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    st, a = cs.static, cs.arrays
    builders = [b for _, b in builds]
    phase("bvh_scene", tris=st.n_tris_real, intersector=st.intersector,
          nodes=a["bvh"]["bb_min"].shape[0],
          leaves=int((a["bvh"]["first_tri"] >= 0).sum()),
          builder=builders, sbvh_aliases=a["sbvh"] is a["bvh"],
          clustered_tables=sorted(k for k in a if k in CLUSTERED_KEYS),
          generate_s=round(gen_s, 3), parse_s=round(parse_s, 3),
          compile_s=round(compile_s, 3),
          build_s=round(sum(s for s, _ in builds), 3),
          pack_s=round(sum(packs), 3),
          packed_bytes=nbytes(*(arrays["bvh"][k] for k in bt.PACKED_KEYS)),
          upload_s=round(upload_s, 3),
          parse_compile_upload_s=round(parse_s + compile_s + upload_s, 3),
          integrator=cfg.integrator, bounces=cfg.bounces,
          filter=cfg.filter_type,
          light_samples=[ls.samples for ls in st.lights],
          size=f"{cfg.width}x{cfg.height}", spp=cfg.aa_samples,
          gpu=repr(smi))
    if st.n_tris_real != BVH_GRID["tris"] or st.intersector != "bvh":
        raise AssertionError(f"bvh_scene: {st.n_tris_real} triangles on "
                             f"{st.intersector!r}")
    if (builders != ["native"] or len(packs) != 1
            or a["sbvh"] is not a["bvh"]
            or any(k in a for k in CLUSTERED_KEYS)):
        raise AssertionError(f"bvh_scene: builds {builders}, packs "
                             f"{len(packs)}, sbvh aliases "
                             f"{a['sbvh'] is a['bvh']}, clustered tables "
                             f"{sorted(k for k in a if k in CLUSTERED_KEYS)}")
    return scene, cfg, cs, arrays


def ray_differ(a: tuple, b: tuple) -> int:
    """Rays (the first dimension) where any tensor of a differs from its
    counterpart in b."""
    n = a[0].shape[0]
    out = torch.zeros((n,), dtype=torch.bool, device=a[0].device)
    for x, y in zip(a, b):
        out |= (x != y).reshape(n, -1).any(dim=1)
    return int(out.sum())


def sectors(offsets: torch.Tensor, size: int) -> torch.Tensor:
    """32-byte sectors a row of `size` bytes at each byte offset spans."""
    return (offsets % 32 + size + 31) // 32


def sectors_per_visit(bvh: dict) -> dict:
    """Sectors a node visit reads, from the layouts, over the tree's nodes:
    the packed record (its place in memory included), and the first
    bodies' box rows (12-byte rows at a 12-byte stride), first_tri, the
    next index and, at a leaf, tri_count."""
    n = bvh["bb_min"].shape[0]
    node = torch.arange(n, dtype=torch.int64, device=bvh["bb_min"].device)
    packed = sectors(bvh["nodes"].data_ptr() + 32 * node, 32)
    before = (sectors(bvh["bb_min"].data_ptr() + 12 * node, 12)
              + sectors(bvh["bb_max"].data_ptr() + 12 * node, 12) + 2
              + (bvh["first_tri"] >= 0).long())
    return dict(packed=round(float(packed.double().mean()), 4),
                before=round(float(before.double().mean()), 4))


def visit_efficiency(visits: torch.Tensor) -> float:
    """A warp's share of useful visits: over the 32-ray groups of `visits`
    (per ray, in the order the warps take them), the sum of the visits
    over the sum of 32 x the group's largest."""
    m = visits.shape[0] // 32 * 32
    g = visits[:m].reshape(-1, 32).double()
    return round(float(g.sum() / (32 * g.max(dim=1).values.sum())), 4)


def before_args(name: str, args: tuple) -> tuple:
    """A recorded call's arguments for the body that the walk of `name`
    replaced: the shadow body reads lf4 in the triangles' order, the walk
    in leaf order."""
    if name == BVH[0]:
        return args
    bvh, tri9, lf4 = args[:3]
    by_tri = torch.empty_like(lf4)
    by_tri[bvh["tri_order"].long()] = lf4
    return (bvh, tri9, by_tri) + tuple(args[3:])


def check_bvh_kernel(name: str, args: tuple, rays: str) -> dict:
    """One BVH kernel on recorded inputs: bit-equal to its plain walk on a
    strided subset of at most BVH_PLAIN_LANES rays and to the body it
    replaced (`_<name>_before`) on every ray, repeated bit for bit, its
    device ms and the replaced body's, its bound from its own walk (the
    counting kernel: node visits and triangle tests per ray, the nodes and
    triangles it touched), the sectors a visit reads in both layouts, the
    warps' visit efficiency, its ptxas registers."""
    closest = name == BVH[0]
    kind = "closest" if closest else "shadow"
    wrapper = getattr(bt, name)
    old_args = before_args(name, args)
    before = getattr(bt, f"_{name}_before")
    scene = args[:2] if closest else args[:3]
    per_ray = args[2:6] if closest else args[3:6]
    n = per_ray[0].shape[0]
    out = wrapper(*args)
    again = wrapper(*args)
    old = before(*old_args)
    torch.cuda.synchronize()
    repeat = ray_differ(out, again)
    differ_old = ray_differ(out, old)
    stride = max(1, -(-n // BVH_PLAIN_LANES))
    sub = scene + tuple(x[::stride].contiguous() for x in per_ray)
    plain_fn = bt.closest_bvh_plain if closest else bt.shadow_bvh_plain
    plain, plain_ms = once_ms(lambda: plain_fn(*sub, counts=True))
    k_sub = tuple(x[::stride] for x in out[:len(plain) - 1])
    m = k_sub[0].shape[0]
    n_differ = ray_differ(k_sub, plain[:-1])
    counted_out, counts, nodes, tris = bt.walk_counts(kind, *args)
    torch.cuda.synchronize()
    count_differ = int((counts[::stride].long() != plain[-1]).any(
        dim=1).sum())
    count_out_differ = ray_differ(out, counted_out)
    if closest:
        hit = out[4][::stride]
        err = max([0.0] + [float((x[hit] - y[hit]).abs().max())
                           for x, y in zip((k_sub[0], k_sub[2], k_sub[3]),
                                           (plain[0], plain[2], plain[3]))
                           if hit.any()])
        io_bytes = n * (32 + 16)  # org, dir, tmin, tmax; t, tri, u, v
        extra = dict(hits=int(out[4].sum()))
    else:
        tr_k = torch.where(k_sub[1][:, None], 0.0, torch.exp(k_sub[0]))
        tr_p = torch.where(plain[1][:, None], 0.0, torch.exp(plain[0]))
        err = float((tr_k - tr_p).abs().max()) if m else 0.0
        io_bytes = n * (28 + 13)  # org, dir, tmax; log sum, blocked
        extra = dict(live=int((per_ray[2] > 0).sum()),
                     blocked=int(out[1].sum()))
    visits = int(counts[:, 0].sum())
    tests = int(counts[:, 1].sum())
    lf4 = 0 if closest else LF4_BYTES
    ops = (BVH_BOX_OPS + int(closest)) * visits + MT_OPS * tests
    b = bound(ops, nodes * NODE_BYTES + tris * (TRI_BYTES + lf4) + io_bytes,
              node_visits=visits,
              tri_tests=tests, nodes_touched=nodes, tris_touched=tris,
              visits_per_ray=round(visits / max(n, 1), 2),
              tests_per_ray=round(tests / max(n, 1), 2))
    ms = device_ms(lambda: wrapper(*args), calls=5, replays=3)
    ms_before = device_ms(lambda: before(*old_args), calls=5, replays=3)
    reg = registers("bvh_walk", f"bvh_{kind}_kernel")
    reg_before = registers("bvh_walk", f"bvh_{kind}_before_kernel")
    phase("kernel", name=name, rays=rays, n=n, compared_rays=m,
          differ=n_differ, repeat_differ=repeat,
          differ_vs_old_body=differ_old, count_differ=count_differ,
          max_abs_err=err,
          tolerance="bit-equal (t, tri, u, v / log sum, blocked)",
          ms=round(ms, 4), ms_before=round(ms_before, 4),
          speedup=round(ms_before / ms, 3), plain_ms=round(plain_ms, 4),
          plain=f"one eager call on every {stride}th ray",
          sectors_per_visit=sectors_per_visit(args[0]),
          warp_visit_efficiency=visit_efficiency(counts[:, 0]),
          **extra, **reg,
          registers_before=reg_before["registers"], **b)
    if n_differ or repeat or differ_old or count_differ or count_out_differ:
        raise AssertionError(f"{name} ({rays}): {n_differ} rays differ "
                             f"from the plain walk, {repeat} between two "
                             f"calls, {differ_old} from the body it "
                             f"replaced, {count_differ} counts from the "
                             f"plain walk's, {count_out_differ} answers "
                             "from the counting kernel's")
    return dict(ms=ms, ms_before=ms_before, plain_ms=plain_ms, err=err,
                bound=b, n=n, **reg)


def bvh_kernels(cs, cfg) -> dict:
    """Both BVH kernels on one 512² step's recorded calls: the closest hit
    on the primary and bounce-1 rays, the shadow sum on the bounce-0 and
    bounce-1 NEE batches."""
    _, _, calls = step_calls(cs, cfg, bt, BVH)
    out = {}
    for name, k, rays in ((BVH[0], 0, "primary"), (BVH[0], 1, "bounce 1"),
                          (BVH[1], 0, "bounce-0 NEE"),
                          (BVH[1], 1, "bounce-1 NEE")):
        out[(name, k)] = check_bvh_kernel(name, calls[name][k], rays)
    del calls
    return out


def bvh_path(smi, scene, cs, cfg, arrays) -> dict:
    """The scene at its own settings (pathtracing, bounces 3, gauss, 512²,
    4 spp) through render_scene(timed=True), counted: per step a closest
    hit and an NEE shadow batch per path vertex, the warm-up step
    included, no other intersection kernel; one profiled step."""
    res, launches = entry_counted(scene, BVH)
    verts = cfg.bounces + 1
    per_step = {BVH[0]: verts, BVH[1]: verts * nee_lights(cs.static)}
    steps = cfg.aa_samples + 1
    path_line("bvh_path", res, cfg, launches,
              {k: v * steps for k, v in per_step.items()}, smi,
              spp=cfg.aa_samples, bounces=cfg.bounces,
              launches_per_step=per_step,
              step_ms=round(1e3 * res.stats["render_s"] / cfg.aa_samples,
                            3))
    dev = engine.resolve_device("cuda")
    step = engine.make_sample_step(cs.static, cs.camera, cfg, dev)
    profile("bvh_profile", res, step, arrays, cfg,
            ("bvh_closest_kernel", "bvh_shadow_kernel"), smi)
    return launches


def bvh_card_vs_cpu(cs, cfg) -> None:
    """The scene at 16², 1 spp on the card (the BVH kernels) and on the CPU
    (the plain walks), one compile: image RMSE <= 1e-4, the film planes
    within 1e-5, rays equal."""
    size = BVH_SMALL["size"]
    small = dataclasses.replace(cs, camera=dataclasses.replace(
        cs.camera, resx=size, resy=size))
    scfg = RenderConfig(**{**cfg.__dict__, "width": size, "height": size,
                           "aa_samples": BVH_SMALL["spp"]})
    t0 = time.perf_counter()
    g = render(small, scfg, device="cuda")
    c = render(small, scfg, device="cpu")
    rmse = float(np.sqrt(np.mean((g.image - c.image) ** 2)))
    planes = {k: float(torch.sqrt(torch.mean(
        (g.film[k].cpu().double() - c.film[k].double()) ** 2)))
        for k in ("wsum", "w", "nsamples")}
    phase("bvh_card_vs_cpu", size=f"{size}x{size}", spp=scfg.aa_samples,
          rmse=rmse, bound=1e-4, planes_rmse=planes, planes_bound=1e-5,
          rays_gpu=g.stats["rays"], rays_cpu=c.stats["rays"],
          image_mean=float(g.image.mean()),
          seconds=round(time.perf_counter() - t0, 3))
    if not (rmse <= 1e-4 and max(planes.values()) <= 1e-5
            and g.stats["rays"] == c.stats["rays"] > 0
            and g.image.mean() > 0.0):
        raise AssertionError("bvh_card_vs_cpu: card and CPU disagree")


def bvh_vs_fine(gscene, gcfg, smi) -> None:
    """The 164K grid (the fine route) with a BVH built over its triangles:
    both intersectors on its primary rays and bounce-0 NEE rays, held to
    the intersection contract (hit equal, tri equal but on exact ties, t
    within rtol 1e-4, transmission within atol 2e-3), and each kernel's
    device ms on those rays."""
    st = gscene.static
    n = st.n_tris_real
    arrays = to_tensors(gscene.arrays, "cuda")
    a = gscene.arrays
    g = a["tri_geom_pack"]
    t0 = time.perf_counter()
    bvh_np = scene_mod.bvh_arrays(g, g, a["shadow_filt"][:n],
                                  a["shadow_filt_binary"][:n])
    build_s = time.perf_counter() - t0
    extra = to_tensors(bvh_np, "cuda")
    barrays = {**arrays, **extra}
    bstatic = dataclasses.replace(st, intersector="bvh")
    primary, shadow = main_path_rays(gscene, gcfg, arrays)
    hf = isect.closest_hit(arrays, st, *primary)
    hb = isect.closest_hit(barrays, bstatic, *primary)
    hit = hf.hit
    other = (hb.tri != hf.tri) & hit
    ties_ok = torch.equal(hb.t[other], hf.t[other])
    t_err = float(((hb.t[hit] - hf.t[hit]).abs()
                   / hf.t[hit].abs().clamp(min=1e-30)).max())
    tf = isect.shadow_transmission(arrays, st, False, *shadow)
    tb = isect.shadow_transmission(barrays, bstatic, False, *shadow)
    tr_err = float((tf - tb).abs().max())
    pk, cl, sub = (arrays[k] for k in ("tri_pack10", "tri_cluster8",
                                       "tri_sub8"))
    logf = ci.log_filter(arrays["sfilt4_binary"])
    tmax_s = bt.shadow_tmax(shadow[2]).contiguous()
    g_t = extra["stri_geom_pack"]
    c_args = (extra["bvh"], g_t, *primary)
    s_args = (extra["bvh"], g_t, extra["sbvh_lf4_binary"], shadow[0],
              shadow[1], tmax_s)
    s_old = before_args(BVH[1], s_args)
    old_body = dict(
        closest=ray_differ(bt.closest_hit_bvh(*c_args),
                           bt._closest_hit_bvh_before(*c_args)),
        shadow=ray_differ(bt.shadow_logsum_bvh(*s_args),
                          bt._shadow_logsum_bvh_before(*s_old)))
    ms = dict(
        closest_fine=device_ms(lambda: fi.closest_hit_fine(
            pk, cl, sub, *primary, n), calls=5, replays=3),
        closest_bvh=device_ms(lambda: bt.closest_hit_bvh(*c_args), calls=5,
                              replays=3),
        closest_bvh_before=device_ms(
            lambda: bt._closest_hit_bvh_before(*c_args), calls=5, replays=3),
        shadow_fine=device_ms(lambda: fi.shadow_logsum_fine(
            pk, cl, sub, logf, *shadow, n), calls=3, replays=3),
        shadow_bvh=device_ms(lambda: bt.shadow_logsum_bvh(*s_args), calls=3,
                             replays=3),
        shadow_bvh_before=device_ms(
            lambda: bt._shadow_logsum_bvh_before(*s_old), calls=3,
            replays=3))
    phase("bvh_vs_fine", tris=n, nodes=bvh_np["bvh"]["bb_min"].shape[0],
          build_s=round(build_s, 3), builder=bvh_mod.last_builder,
          rays=primary[0].shape[0], hits=int(hit.sum()),
          hit_differ=int((hb.hit != hf.hit).sum()),
          tri_differ=int(other.sum()), ties_only=ties_ok, t_rel_err=t_err,
          shadow_rays=shadow[0].shape[0], transmission_err=tr_err,
          tolerance="hit equal, tri on exact ties only, t rtol 1e-4, "
          "transmission atol 2e-3; the replaced bodies bit-equal",
          differ_vs_old_body=old_body,
          ms={k: round(v, 4) for k, v in ms.items()}, gpu=repr(smi))
    if not (torch.equal(hb.hit, hf.hit) and ties_ok and t_err <= 1e-4
            and tr_err <= 2e-3):
        raise AssertionError("bvh_vs_fine: the BVH and the fine kernels "
                             "break the intersection contract")
    if any(old_body.values()):
        raise AssertionError(f"bvh_vs_fine: rays differ from the replaced "
                             f"bodies: {old_body}")


def exr_ibl(smi, out_dir: str) -> None:
    """scenes/assets/env.hdr's pixels written by the port's EXR writer as
    float32 NONE, ZIPS, PIZ and 16x16-tiled ZIPS, each read back equal to
    the pixels; ibl_spheres.xml pointed at each (a copy) and rendered on
    the card at 64², 4 spp: every film bit-equal to the NONE one."""
    from libyafaray_tpu_torch.io.exr import write_exr_multilayer
    from libyafaray_tpu_torch.io.rgbe import read_hdr

    asset = "scenes/assets/env.hdr"
    px = read_hdr(asset)
    with open(IBL) as f:
        text = f.read()
    if asset not in text:
        raise AssertionError(f"{IBL}: does not name {asset}")
    films, sizes, t0 = {}, {}, time.perf_counter()
    for label, kw in EXR_IBL["codecs"]:
        path = os.path.join(out_dir, f"env_{label}.exr")
        write_exr_multilayer(path, {"": px}, label.split("_")[0], **kw)
        sizes[label] = os.path.getsize(path)
        back = read_exr(path)
        if not np.array_equal(back.view(np.uint32), px.view(np.uint32)):
            raise AssertionError(f"exr_ibl: {label} does not read back")
        xml = os.path.join(out_dir, f"ibl_{label}.xml")
        with open(xml, "w") as f:
            f.write(text.replace(asset, path))
        res = render_scene(scene_at(xml, dict(
            width=EXR_IBL["size"], height=EXR_IBL["size"],
            AA_minsamples=EXR_IBL["spp"])), device="cuda")
        films[label] = (res.image, {k: v.cpu().numpy()
                                    for k, v in res.film.items()})
    ref_img, ref_film = films["none"]
    equal = {label: bool(np.array_equal(img, ref_img) and all(
        np.array_equal(f[k], ref_film[k]) for k in ref_film))
        for label, (img, f) in films.items()}
    phase("exr_ibl", env=f"{px.shape[0]}x{px.shape[1]}", bytes=sizes,
          size=f"{EXR_IBL['size']}x{EXR_IBL['size']}", spp=EXR_IBL["spp"],
          film_equal_to_none=equal, image_mean=float(ref_img.mean()),
          seconds=round(time.perf_counter() - t0, 3), gpu=repr(smi))
    if not all(equal.values()) or not ref_img.mean() > 0.0:
        raise AssertionError(f"exr_ibl: films differ across the lossless "
                             f"codecs: {equal}")


def _interface_params(yi, el) -> None:
    """An XML element's leaf params as the flat API's params_set_* calls,
    by their attributes (colors r g b [a], points x y z, matrices)."""
    for child in el:
        a = child.attrib
        if "ival" in a:
            yi.params_set_int(child.tag, int(a["ival"]))
        elif "fval" in a:
            yi.params_set_float(child.tag, float(a["fval"]))
        elif "bval" in a:
            yi.params_set_bool(child.tag, a["bval"].lower() in (
                "true", "1", "yes", "on"))
        elif "sval" in a:
            yi.params_set_string(child.tag, a["sval"])
        elif "r" in a:
            yi.params_set_color(child.tag, float(a["r"]), float(a["g"]),
                                float(a["b"]), float(a.get("a", 1.0)))
        elif "x" in a:
            yi.params_set_point(child.tag, float(a["x"]), float(a["y"]),
                                float(a["z"]))
        elif "m00" in a:
            yi.params_set_matrix(child.tag, [float(a[f"m{i}{j}"])
                                             for i in range(4)
                                             for j in range(4)])
        else:
            raise AssertionError(f"interface: no call for <{child.tag}>")


def interface_scene(path: str, **render_params):
    """The scene of an XML file built through the flat API's calls, as an
    exporter would make them, `render_params` overriding its <render>
    block's; returns the Interface ready to render."""
    import xml.etree.ElementTree as ET

    from libyafaray_tpu_torch.scene.interface import Interface

    yi = Interface()
    create = dict(texture=yi.create_texture, material=yi.create_material,
                  light=yi.create_light, camera=yi.create_camera,
                  background=yi.create_background,
                  integrator=yi.create_integrator,
                  volumeregion=yi.create_volume_region)
    for el in ET.parse(path).getroot():
        if el.tag in create:
            _interface_params(yi, el)
            create[el.tag](el.attrib.get("name", "") or "default")
        elif el.tag == "mesh":
            a = el.attrib
            has_uv = a.get("has_uv", "false").lower() in ("true", "1")
            yi.start_tri_mesh(int(a["id"]), int(a.get("vertices", 0)),
                              int(a.get("faces", 0)),
                              a.get("has_orco", "false").lower() in (
                                  "true", "1"), has_uv, 0,
                              a.get("visibility", "normal"))
            mat = 0
            for c in el:
                ca = c.attrib
                if c.tag == "p":
                    yi.add_vertex(float(ca["x"]), float(ca["y"]),
                                  float(ca["z"]))
                elif c.tag == "n":
                    yi.add_normal(float(ca["x"]), float(ca["y"]),
                                  float(ca["z"]))
                elif c.tag == "uv":
                    yi.add_uv(float(ca["u"]), float(ca["v"]))
                elif c.tag == "set_material":
                    mat = ca["sval"]
                elif has_uv and "uv_a" in ca:
                    yi.add_triangle_uv(int(ca["a"]), int(ca["b"]),
                                       int(ca["c"]), int(ca["uv_a"]),
                                       int(ca["uv_b"]), int(ca["uv_c"]), mat)
                else:
                    yi.add_triangle(int(ca["a"]), int(ca["b"]), int(ca["c"]),
                                    mat)
            yi.end_tri_mesh()
        elif el.tag == "render":
            _interface_params(yi, el)
        else:
            raise AssertionError(f"interface: no call for <{el.tag}>")
    for k, v in render_params.items():
        yi.params_set_int(k, v)
    return yi


def interface_phase(smi, out_dir: str) -> None:
    """cornell.xml built through the flat API and rendered on the card at
    64², 4 spp: image and film bit-equal to the XML route's render_scene;
    then `python -m libyafaray_tpu_torch` on cornell.xml at 32² writes an
    .exr that `python -m libyafaray_tpu_torch.cli.compare` finds at RMSE
    0 (exit 0, --threshold 0) against the same render_scene call's image."""
    from libyafaray_tpu_torch.io.exr import write_exr

    t0 = time.perf_counter()
    size, spp = INTERFACE["size"], INTERFACE["spp"]
    yi = interface_scene(CORNELL, width=size, height=size,
                         AA_minsamples=spp)
    api = yi.render(device="cuda")
    xml = render_scene(scene_at(CORNELL, dict(
        width=size, height=size, AA_minsamples=spp)), device="cuda")
    equal = bool(np.array_equal(api.image, xml.image) and all(
        torch.equal(api.film[k], xml.film[k]) for k in xml.film))
    api_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cs = INTERFACE["cli_size"]
    out, ref = (os.path.join(out_dir, f) for f in ("cli.exr", "ref.exr"))
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-m", "libyafaray_tpu_torch",
                        CORNELL, out, "--width", str(cs), "--height",
                        str(cs), "-vl", "warning"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"interface: python -m libyafaray_tpu_torch "
                             f"exited {r.returncode}: {r.stderr[-2000:]}")
    same = render_scene(scene_at(CORNELL, dict(width=cs, height=cs)),
                        device="cuda")
    write_exr(ref, same.image)
    c = subprocess.run([sys.executable, "-m",
                        "libyafaray_tpu_torch.cli.compare", out, ref,
                        "--threshold", "0"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    line = json.loads(c.stdout.strip().splitlines()[-1])
    phase("interface", size=f"{size}x{size}", spp=spp,
          film_equal_to_xml=equal, rays=api.stats["rays"],
          api_s=round(api_s, 3), cli_size=f"{cs}x{cs}",
          cli_rc=r.returncode, compare_rc=c.returncode, compare=line,
          cli_s=round(time.perf_counter() - t0, 3), gpu=repr(smi))
    if not (equal and api.image.mean() > 0.0):
        raise AssertionError("interface: the flat API's render differs "
                             "from the XML route's")
    if c.returncode != 0 or line.get("rmse") != 0.0:
        raise AssertionError(f"interface: compare exited {c.returncode}: "
                             f"{line}")


def slice22_phases(smi, out_dir: str, kernels: list,
                   vs_fine_done: bool = False) -> None:
    """Scenes above 2^20 triangles on the threaded BVH (the 2.6M-triangle
    grid: its compile, both BVH kernels bit-equal to their plain walks on
    recorded rays, the path at its own settings, a profiled step, the card
    against the CPU), the BVH against the fine kernels on the 164K grid
    (run inside the grid phases unless `vs_fine_done` is False), the EXR
    codecs under an IBL render, and the flat API, the CLI module and the
    compare tool.  Appends the two BVH kernels' entries to `kernels`."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as scenes:
        scene, cfg, cs, arrays = bvh_scene(smi, scenes)
        chk = bvh_kernels(cs, cfg)
        launches = bvh_path(smi, scene, cs, cfg, arrays)
        del arrays
        bvh_card_vs_cpu(cs, cfg)
        del scene, cs
        if not vs_fine_done:
            path = make_grid(scenes, GRID["grid"], GRID["subdiv"])
            gscene, gcfg = grid(path, GRID["size"], GRID["spp"], "cuda")
            bvh_vs_fine(gscene, gcfg, smi)
            del gscene
    exr_ibl(smi, out_dir)
    interface_phase(smi, out_dir)
    for name, line in zip(BVH, (53, 106)):
        first, second = chk[(name, 0)], chk[(name, 1)]
        kernels.append(dict(
            name=name, route="cuda", source=SRC.format("bvh_walk"),
            replaces=BVH_REPLACES.format(line), launches=launches[name],
            max_abs_err=max(first["err"], second["err"]), ms=first["ms"],
            plain_ms=first["plain_ms"], rays=first["n"], **first["bound"],
            ms_before=first["ms_before"], ms_bounce1=second["ms"],
            ms_before_bounce1=second["ms_before"],
            plain_ms_bounce1=second["plain_ms"], rays_bounce1=second["n"],
            bound_ms_bounce1=second["bound"]["bound_ms"],
            registers=first["registers"],
            spill_stores=first["spill_stores"]))
    phase("slice22", seconds=round(time.perf_counter() - t0, 3))


# slice 24: several devices as the ranks of one gloo group.  The card's
# machine has one card, so both ranks share it: the group checks that a
# sharded render is the one-device render, not how it scales.
MULTI_RANKS = 2
MULTI_SIZE = 128
MULTI_CLI_SIZE = 64
MULTI_TIMEOUT_S = 300.0
MULTI_DEVICE = "cuda"
# the slice's kernels: rows 1-2 on every render, 11-12 on the photon ones
MULTI_KERNELS = TINY + ("density_flash", "nearest_flash")


def multi_scenes() -> dict:
    """name -> (scene, image bound) of the [multidevice_path] group: the
    main path at full width (cornell.xml as pathtracing, 512², 64 spp,
    bounces 4, through render_scene(timed=True), the [main_path] phase's
    route), then at 128² cornell_photon.xml and cornell_sppm.xml (4
    passes) at their photon settings, cornell_bidir.xml at 4 spp and
    adaptive AA over 4 passes (4 spp, then 2 a pass, threshold 0.3: each
    rank's later passes run compact over its band).  The bounds are the
    reference's (tests/test_parallel.py, tests/test_veach.py)."""
    s = MULTI_SIZE
    return dict(
        main=(scene_at(CORNELL, dict(
            width=MAIN["size"], height=MAIN["size"],
            AA_minsamples=MAIN["spp"], AA_passes=1), dict(
                type="pathtracing", bounces=MAIN["bounces"],
                russian_roulette_min_bounces=MAIN["rr_min_bounces"])), 1e-5),
        photon=(scene_at(PHOTON, dict(width=s, height=s)), 1e-4),
        sppm=(scene_at(CORNELL_SPPM, dict(width=s, height=s),
                       dict(passNums=4)), 1e-4),
        bidir=(scene_at(BIDIR, dict(width=s, height=s, AA_minsamples=4)),
               1e-4),
        adaptive=(adaptive_scene(s, AA_minsamples=4, AA_inc_samples=2,
                                 AA_threshold=0.3), 1e-5),
    )


def render_steps(res, timed: bool = False) -> int:
    """Sample steps (SPPM: passes) a render ran, for launches a step; a
    timed render's warm-up step included."""
    st, cfg = res.stats, res.cfg
    if "pass_log" in st:  # path tracing, adaptive
        return sum(e["steps"] for e in st["pass_log"])
    if "bdpt_steps" in st:
        return st["bdpt_steps"]
    if "photons" in st:  # SPPM
        return st["passes"]
    if cfg.integrator == "photonmapping":
        return cfg.aa_samples * cfg.aa_passes
    # render_timed
    return -(-cfg.aa_samples * cfg.aa_passes // max(1, cfg.spp_batch)) + timed


def multi_rank(rank: int, out_dir: str) -> None:
    """One rank of the [multidevice_path] group: every render of
    `multi_scenes` through render_scene inside the group, its launches
    counted (set to 0 just before, read just after); its film, stats and
    launches written to out_dir; then the photon maps built over the
    mesh, their packs written."""
    import torch.distributed as dist

    from libyafaray_tpu_torch.parallel.mesh import make_device_mesh

    for name, (scene, _) in multi_scenes().items():
        res, launches = counted(lambda: render_scene(
            scene, device=MULTI_DEVICE, timed=name == "main"))
        np.savez(os.path.join(out_dir, f"{name}.{rank}.npz"),
                 **{k: v.cpu().numpy() for k, v in res.film.items()})
        with open(os.path.join(out_dir, f"{name}.{rank}.json"), "w") as f:
            json.dump(dict(stats=res.stats, launches=launches,
                           steps=render_steps(res, name == "main"),
                           backend=dist.get_backend()), f, default=str)
    scene = multi_scenes()["photon"][0]
    cs = scene.compile(device=MULTI_DEVICE)
    mesh = make_device_mesh(height=MULTI_SIZE, device=MULTI_DEVICE)
    maps = photonmap.build_photon_maps(cs, build_config(scene),
                                       to_tensors(cs.arrays, mesh.device),
                                       mesh=mesh)
    np.savez(os.path.join(out_dir, f"packs.{rank}.npz"),
             **{k: v.cpu().numpy() for k, v in flat_packs(maps).items()})


def flat_packs(maps: dict) -> dict:
    """The tensors of a build_photon_maps result's packs by map.key."""
    return {f"{m}.{k}": v for m in ("diffuse", "caustic", "radiance")
            if maps[m] is not None for k, v in maps[m].items()
            if isinstance(v, torch.Tensor)}


def differ_rows(a: np.ndarray, b: np.ndarray) -> tuple:
    """(pixels where two images differ, their rows, max |a - b|)."""
    d = np.abs(a.astype(np.float64) - b.astype(np.float64)).max(axis=-1)
    rows = sorted(set(np.nonzero(d)[0].tolist()))
    return int((d > 0).sum()), rows, float(d.max())


def multi_render_line(name, bound, got: list, one, smi) -> None:
    """The phase line of one sharded render against the one-device render
    of the same call, and its checks (module comment of MULTI_RANKS)."""
    films = [f for f, _ in got]
    stats = [j["stats"] for _, j in got]
    for f in films[1:]:
        for k in films[0]:
            if not np.array_equal(films[0][k], f[k]):
                raise AssertionError(f"{name}: ranks return other {k}")
    img = engine_image(films[0])
    n_diff, rows, err = differ_rows(img, one.image)
    rays, one_rays = stats[0]["rays"], one.stats["rays"]
    rank_rays = [st["rank_rays"] for st in stats]
    # a float32 counter of ~1e8 rays has an ulp of 8: within 1e-6 there
    ray_tol = 1.0 if one_rays < 1e7 else 1e-6 * one_rays
    # the lanes each rank's sample steps ran (pass 0's under adaptive
    # passes, whose compact buckets are per band), against one device's
    adaptive = one.cfg.aa_passes > 1 and "pass_log" in one.stats
    lanes = [st["pass_log"][0]["lanes"] if adaptive else st["lanes_traced"]
             for st in stats]
    lanes_one = (one.stats["pass_log"][0]["lanes"] if adaptive
                 else one.stats["lanes_traced"])
    per_step = [{k: round(j["launches"][k] / max(j["steps"], 1), 3)
                 for k in MULTI_KERNELS if j["launches"][k]}
                for _, j in got]
    extra = {}
    if "density" in films[0] and name == "bidir":
        dd = films[0]["density"].astype(np.float64) \
            - one.film["density"].cpu().numpy()
        extra["density_rmse"] = float(np.sqrt(np.mean(dd ** 2)))
    if "pass_log" in one.stats:
        extra["flagged_by_rank"] = [[e.get("band_flagged") for e in
                                     st["pass_log"]] for st in stats]
        extra["flagged_one"] = [e["flagged"] for e in
                                one.stats["pass_log"]]
        extra["pass_lanes_by_rank"] = [[e["lanes"] for e in st["pass_log"]]
                                       for st in stats]
        extra["pass_modes_by_rank"] = [[e["mode"] for e in st["pass_log"]]
                                       for st in stats]
    phase("multidevice_path", render=name,
          size=f"{one.cfg.width}x{one.cfg.height}", ranks=len(got),
          backend=got[0][1]["backend"], max_abs=err, bound=bound,
          pixels_differ=n_diff, rows_differ=rows[:16], rays=rays,
          rays_one=one_rays, rank_rays=rank_rays,
          lanes_by_rank=lanes, lanes_one=lanes_one,
          launches_by_rank=[{k: j["launches"][k] for k in MULTI_KERNELS
                             if j["launches"][k]} for _, j in got],
          launches_per_step_by_rank=per_step,
          render_s_by_rank=[round(st["render_s"], 4) for st in stats],
          render_s_one=round(one.stats["render_s"], 4),
          reduce_ms_by_rank=[round(1e3 * st.get("reduce_s", 0.0), 3)
                             for st in stats], **extra, gpu=repr(smi))
    if not (np.isfinite(img).all() and err <= bound):
        raise AssertionError(f"{name}: sharded image off by {err}")
    if abs(rays - one_rays) > ray_tol or abs(sum(rank_rays)
                                             - one_rays) > ray_tol:
        raise AssertionError(f"{name}: rays {rays} / ranks {rank_rays} "
                             f"against {one_rays}")
    if not (sum(lanes) == lanes_one > 0 and all(lanes)):
        raise AssertionError(f"{name}: the ranks traced {lanes} lanes "
                             f"against {lanes_one}")
    if extra.get("density_rmse", 0.0) > 1e-5:
        raise AssertionError(f"{name}: density RMSE {extra}")
    if "flagged_one" in extra and [sum(x) for x in zip(
            *extra["flagged_by_rank"])] != extra["flagged_one"][
                :len(extra["flagged_by_rank"][0])]:
        raise AssertionError(f"{name}: flagged pixels by band {extra}")
    want = TINY + (("density_flash", "nearest_flash") if name == "photon"
                   else ("density_flash",) if name == "sppm" else ())
    for _, j in got:
        if any(not j["launches"][k] for k in want):
            raise AssertionError(f"{name}: a kernel of the path did not "
                                 f"launch: {j['launches']}")


def engine_image(film: dict) -> np.ndarray:
    """film_image of a host film."""
    from libyafaray_tpu_torch.film.imagefilm import film_image

    return film_image({k: torch.from_numpy(v) for k, v in film.items()
                       }).numpy()


def multi_cli(smi, out_dir: str) -> None:
    """cornell.xml through the CLI under two env-initialised ranks (the
    variables torchrun sets, a localhost rendezvous) at 64²: rank 0's .exr
    against the one-device CLI's."""
    import socket

    t0 = time.perf_counter()
    size = str(MULTI_CLI_SIZE)
    out, ref = (os.path.join(out_dir, f) for f in ("ranks.exr", "one.exr"))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port), WORLD_SIZE=str(MULTI_RANKS),
               LOCAL_WORLD_SIZE=str(MULTI_RANKS))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "libyafaray_tpu_torch.cli.yafaray_xml",
         CORNELL, out, "--width", size, "--height", size, "-vl", "warning",
         "--device", MULTI_DEVICE],
        cwd=REPO, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(MULTI_RANKS)]
    try:
        # the one-device CLI, here while the ranks start (nothing timed)
        one_rc = cli_main([CORNELL, ref, "--width", size, "--height", size,
                           "-vl", "warning", "--device", MULTI_DEVICE])
        outs = [p.communicate(timeout=MULTI_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            p.kill()
    rcs = [p.returncode for p in procs]
    ranks_s = time.perf_counter() - t0
    if any(rcs):
        raise AssertionError(f"multidevice_cli: ranks exited {rcs}: "
                             f"{[o[1][-2000:] for o in outs]}")
    if one_rc != 0:
        raise AssertionError("multidevice_cli: the one-device CLI failed")
    a, b = read_exr(out), read_exr(ref)
    n_diff, rows, err = differ_rows(a, b)
    phase("multidevice_cli", size=f"{size}x{size}", ranks=MULTI_RANKS,
          rcs=rcs, max_abs=err, bound=1e-5, pixels_differ=n_diff,
          rows_differ=rows[:16], ranks_s=round(ranks_s, 3),
          seconds=round(time.perf_counter() - t0, 3), gpu=repr(smi))
    if not (a.shape == b.shape and err <= 1e-5 and a.mean() > 0.0):
        raise AssertionError(f"multidevice_cli: ranks' image off by {err}")


def slice24_phases(smi, out_dir: str, kernels: list, main=None) -> None:
    """Several devices (slice 24): two gloo ranks on the one card render
    every scene of `multi_scenes` inside one group, each held to the
    one-device render of the same call in this process (the main path's
    is `main`, the [main_path] phase's render, where given: the same
    film); the photon packs built over the mesh bit-equal to the
    one-device packs; the CLI under two env-initialised ranks.  Both
    ranks share one card, so nothing here measures scaling.  The launches
    each rank made go into the `kernels` entries of rows 1-2 and 11-12
    (launches_multidevice_by_rank)."""
    from libyafaray_tpu_torch.parallel import distributed as pd

    t0 = time.perf_counter()
    pd.spawn_ranks(multi_rank, MULTI_RANKS, (out_dir,), device=MULTI_DEVICE,
                   timeout_s=MULTI_TIMEOUT_S)
    phase("multidevice_ranks", ranks=MULTI_RANKS,
          seconds=round(time.perf_counter() - t0, 3))
    total = [dict.fromkeys(MULTI_KERNELS, 0) for _ in range(MULTI_RANKS)]
    for name, (scene, bound) in multi_scenes().items():
        got = []
        for r in range(MULTI_RANKS):
            base = os.path.join(out_dir, f"{name}.{r}")
            with open(base + ".json") as f:
                got.append((dict(np.load(base + ".npz")), json.load(f)))
            for k in MULTI_KERNELS:
                total[r][k] += got[-1][1]["launches"][k]
        one = (main if name == "main" and main is not None
               else render_scene(scene, device=MULTI_DEVICE,
                                 timed=name == "main"))
        multi_render_line(name, bound, got, one, smi)
    scene = multi_scenes()["photon"][0]
    cs = scene.compile(device=MULTI_DEVICE)
    one = flat_packs(photonmap.build_photon_maps(
        cs, build_config(scene), to_tensors(cs.arrays, MULTI_DEVICE)))
    equal = []
    for r in range(MULTI_RANKS):
        packs = dict(np.load(os.path.join(out_dir, f"packs.{r}.npz")))
        equal.append(sorted(packs) == sorted(one) and all(
            np.array_equal(packs[k], v.cpu().numpy()) for k, v in one.items()))
    phase("multidevice_packs", packs=len(one), bit_equal_by_rank=equal)
    if not all(equal):
        raise AssertionError("multidevice_packs: a rank's photon packs "
                             "differ from the one-device packs")
    multi_cli(smi, out_dir)
    for k in kernels:
        if k["name"] in MULTI_KERNELS:
            k["launches_multidevice_by_rank"] = [t[k["name"]]
                                                 for t in total]
    phase("slice24", seconds=round(time.perf_counter() - t0, 3))


def main_golden() -> None:
    """The main path's physics: cornell.xml as pathtracing at the golden's
    96², 64 spp, bounces 6, against the stored golden (RMSE < 0.02)."""
    golden = read_exr(GOLDEN)
    gs = golden.shape[0]
    cs, cc = cornell(size=gs, spp=64, bounces=6, rr_min_bounces=2,
                     device="cuda")
    rmse_g = float(np.sqrt(np.mean((render(cs, cc, device="cuda").image
                                    - golden) ** 2)))
    phase("golden", size=f"{gs}x{gs}", spp=64, bounces=6, rmse=rmse_g,
          bound=0.02)
    if not rmse_g < 0.02:
        raise AssertionError(f"golden RMSE {rmse_g} >= 0.02")


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("slice17", "slice18", "slice19",
                                       "slice20", "slice21", "slice22",
                                       "slice24", "slice25"),
                    default=None,
                    help="run only this slice's phases after the build (an "
                         "iteration run: it prints no result line)")
    only = ap.parse_args(argv).only
    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False); nothing was run")
    # scenes name their assets relative to the repository root
    os.chdir(REPO)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    phase("device", kind=repr(kind), count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda)
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        libs = list(pool.map(_build.build, SOURCES))
    for name, lib in zip(SOURCES, libs):
        _build.load(name)
        phase("build", source=name,
              seconds=round(time.perf_counter() - t0, 3),
              lib=os.path.relpath(lib, REPO))
        with open(lib[:-3] + ".log") as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    print("  ptxas: " + line.strip(), flush=True)

    if only:
        with tempfile.TemporaryDirectory() as out_dir:
            {"slice17": slice17_phases,
             "slice18": slice18_phases,
             "slice19": slice19_phases,
             "slice20": slice20_phases,
             "slice21": slice21_phases,
             "slice22": slice22_phases,
             "slice24": slice24_phases,
             "slice25": slice25_phases}[only](smi, out_dir, [])
            run_deferred()
        print(smi, flush=True)
        print(f"chip_smoke: --only {only} ran; no result line", flush=True)
        return

    # 3. kernels vs plain at the main path's shapes
    cscene, cfg = cornell(device="cuda", **MAIN)
    arrays = to_tensors(cscene.arrays, "cuda")
    kernels = check_kernels(cscene, cfg, arrays)

    # 4. main path at full size, through the kernels
    res, launches = render_counted(cscene, cfg, ("closest_hit_tiny",
                                                 "shadow_logsum_tiny"))
    check_path("main_path", res, cfg, launches, smi)
    main_res = res  # slice 24's one-device main path
    for k in kernels:
        k["launches"] = launches[k["name"]]

    # 5. where one step's time goes
    profile("profile", res, *path_step(cscene, cfg), cfg, ("tiny_kernel",),
            smi)

    # 6. physics on the card: the stored golden (96², 256 spp)
    defer_card(main_golden)

    # 7. card vs CPU on the same QMC stream
    card_vs_cpu("card_vs_cpu", lambda dev: cornell(
        size=64, spp=4, bounces=4, rr_min_bounces=2, device=dev), 64, 4)

    with tempfile.TemporaryDirectory() as scenes:
        # 8. slice 2: the 164K-triangle grid-spheres scene
        t0 = time.perf_counter()
        path = make_grid(scenes, GRID["grid"], GRID["subdiv"])
        gen_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        gscene, gcfg = grid(path, GRID["size"], GRID["spp"], "cuda")
        garrays = to_tensors(gscene.arrays, "cuda")
        torch.cuda.synchronize()
        phase("grid_scene", tris=gscene.static.n_tris_real,
              pack=tuple(gscene.arrays["tri_pack10"].shape),
              clusters=gscene.arrays["tri_cluster8"].shape[1],
              sub_clusters=gscene.arrays["tri_sub8"].shape[1],
              generate_s=round(gen_s, 3),
              parse_compile_upload_s=round(time.perf_counter() - t0, 3),
              integrator=gcfg.integrator, bounces=gcfg.bounces,
              filter=gcfg.filter_type)
        fine = check_fine_kernels(gscene, gcfg, garrays)
        del garrays
        res, launches = render_counted(gscene, gcfg, ("closest_hit_fine",
                                                      "shadow_logsum_fine"))
        check_path("grid_path", res, gcfg, launches, smi)
        for k in fine:
            k["launches"] = launches[k["name"]]
        grid_prof = profile("grid_profile", res, *path_step(gscene, gcfg),
                            gcfg, ("fine_kernel",), smi)

        # 9. slice 2 card vs CPU on a small generated grid (fine path too)
        small = make_grid(scenes, 2, 2)
        card_vs_cpu("grid_card_vs_cpu", lambda dev: grid(small, 32, 2, dev),
                    32, 2)

        # 10. slice 5: the pair route on the grid, the 10K grid and the soup
        pairs = pairs_phases(scenes, path, gscene, gcfg, res, fine,
                             grid_prof, smi)
        # slice 22's BVH against the fine kernels, on this grid
        bvh_vs_fine(gscene, gcfg, smi)

        # 11. slice 4: the mid-size scenes on the dense and stream kernels
        mid = mid_phases(scenes, smi)

    # 12. slice 3: photon mapping on cornell_photon.xml
    photon = photon_phases(smi)

    # 13. slice 14: directlighting, Beer glass, the caustic map and SPPM
    with tempfile.TemporaryDirectory() as out_dir:
        slice14_phases(smi, out_dir, kernels + photon)
        # 14. slice 15: IBL and textures on ibl_spheres.xml
        slice15_phases(smi, out_dir, kernels)

    # 15. slice 16: adaptive AA and spp_batch on the Cornell main path
    slice16_phases(smi, kernels)

    # 16. slice 17: BDPT on cornell_bidir.xml and the DebugIntegrator
    with tempfile.TemporaryDirectory() as out_dir:
        slice17_phases(smi, out_dir, kernels)

    # 17. slice 18: every light type on cornell_lights.xml
    with tempfile.TemporaryDirectory() as out_dir:
        slice18_phases(smi, out_dir, mid + photon)

    # 18. slice 19: cameras, sky backgrounds, volumes, visibility
    with tempfile.TemporaryDirectory() as out_dir:
        slice19_phases(smi, out_dir, kernels + mid)

    # 19. slice 20: the film layer (passes, alpha, resume, denoise, EXR)
    with tempfile.TemporaryDirectory() as out_dir:
        slice20_phases(smi, out_dir, kernels)

    # 20. slice 21: smoothing, instances, rough glass and dispersion
    with tempfile.TemporaryDirectory() as out_dir:
        slice21_phases(smi, out_dir, mid)

    # 21. slice 22: the 2.6M-triangle grid on the BVH, the EXR codecs, the
    # flat API, the CLI module and the compare tool
    bvh = []
    with tempfile.TemporaryDirectory() as out_dir:
        slice22_phases(smi, out_dir, bvh, vs_fine_done=True)

    # 22. the untimed checks (card against CPU, goldens), together
    run_deferred()

    # 23. slice 24: several devices, two ranks of one group on the card
    with tempfile.TemporaryDirectory() as out_dir:
        slice24_phases(smi, out_dir, kernels + photon, main=main_res)

    print(json.dumps({"kernels": kernels + fine + photon + mid + pairs
                      + bvh}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
