"""Multi-device rendering in the port (libyafaray_tpu_torch/parallel,
the `mesh=` paths of the render loops, `render_scene(n_devices=...)`) on
the CPU, two gloo ranks:

- one module fixture starts the two ranks once; inside that group they
  render every case through `render_scene` (path tracing, direct lighting,
  three adaptive passes with compact bands, photon mapping with its maps,
  SPPM, BDPT with its t=1 density plane, a film resumed from pass 1; path
  tracing, photon mapping, SPPM and BDPT again with timed=True),
  `render_sharded_global` and `build_photon_maps`, and write their films;
  then rank 1 dies, and the parent must raise well inside the group's
  timeout;
- each case is held to the port's one-process render of the same call:
  image max |d| <= 1e-5 for path tracing, direct lighting, adaptive and the
  resume, <= 1e-4 for photon mapping, SPPM and BDPT (the reference's
  tests/test_parallel.py and tests/test_veach.py bounds), BDPT's density
  RMSE <= 1e-5, rays within 1, the ranks' rays and traced lanes summing to
  the one-process counts, both ranks returning the same film, the photon
  packs bit-equal;
- the slice as a whole against the JAX package once: the reference's
  `render_sharded` on a 2-device mesh (compiled in the fixture's process
  while the ranks render) against the port's 2-rank
  `render_sharded`, at tests/test_parallel.py's small_scene (32², 2 spp,
  bounces 2, pathtracing): atol 1e-5, rays within 1;
- with no processes: the device count rule and the row bands against the
  reference's `_auto_mesh`, and the plane table against its
  `film_shardings_for`."""
import dataclasses
import json
import os
import shutil
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch.multiprocessing import ProcessExitedException, \
    ProcessRaisedException

from libyafaray_tpu_torch.convert import to_tensors
from libyafaray_tpu_torch.film import imagefilm as pfilm
from libyafaray_tpu_torch.film.passes import PASS_NAMES, film_add_passes
from libyafaray_tpu_torch.integrators.photonmap import build_photon_maps
from libyafaray_tpu_torch.parallel import distributed as pd
from libyafaray_tpu_torch.parallel.mesh import (auto_devices, band_rows,
                                                film_shardings_for,
                                                make_device_mesh)
from libyafaray_tpu_torch.scene.session import (build_config,
                                                n_devices_for, render_scene)
from libyafaray_tpu_torch.scene.xml_parser import parse_xml_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(REPO, "scenes")
# seconds a rank waits in a collective for a peer; the dead-rank test
# holds the parent to well under it
GROUP_TIMEOUT_S = 120.0
DEAD_EXIT = 17
# name -> (scene file, render parameters, integrator parameters, image
# bound); 48² for the adaptive case: a band of 1,152 pixels takes a
# 512-lane compact pass
CASES = {
    "pathtracing": ("cornell.xml", dict(width=16, height=16,
                                        AA_minsamples=2),
                    dict(type="pathtracing", bounces=2), 1e-5),
    "directlighting": ("cornell.xml", dict(width=16, height=16,
                                           AA_minsamples=2), {}, 1e-5),
    "adaptive": ("cornell.xml", dict(width=48, height=48, AA_minsamples=2,
                                     AA_passes=3, AA_inc_samples=1,
                                     AA_threshold=0.3),
                 dict(type="pathtracing", bounces=2), 1e-5),
    "photonmapping": ("cornell_photon.xml", dict(width=16, height=16,
                                                 AA_minsamples=1),
                      dict(photons=2048, cPhotons=1024, fg_samples=2), 1e-4),
    "SPPM": ("cornell_sppm.xml", dict(width=16, height=16),
             dict(photons=2048, passNums=2), 1e-4),
    "bidirectional": ("cornell_bidir.xml", dict(width=16, height=16,
                                                AA_minsamples=1), {}, 1e-4),
    "resume": ("cornell.xml", dict(width=16, height=16, AA_minsamples=1,
                                   AA_passes=2, AA_inc_samples=1,
                                   AA_threshold=0.0,
                                   film_save_load="load-save"),
               dict(type="pathtracing", bounces=2), 1e-5),
}
# cases rendered again through render_scene(timed=True), the benchmark's
# route (render_timed and the photon, SPPM and BDPT timed variants)
TIMED = ("pathtracing", "photonmapping", "SPPM", "bidirectional")
RENDERS = list(CASES) + [f"{name}_timed" for name in TIMED]


def _scene(name: str):
    path, render, integ, _ = CASES[name]
    s = parse_xml_file(os.path.join(SCENES, path))
    s.render_params.update(render)
    for p in s.integrator_params.values():
        if p.get_str("type", "") != "none" and "Integrator" not in \
                p.get_str("type", ""):
            p.update(integ)
    return s


def _small_scene():
    """tests/test_parallel.py's small_scene: cornell.xml at 32², 2 spp,
    pathtracing, bounces 2."""
    s = parse_xml_file(os.path.join(SCENES, "cornell.xml"))
    s.render_params["width"] = 32
    s.render_params["height"] = 32
    cfg = dataclasses.replace(build_config(s), integrator="pathtracing",
                              bounces=2, width=32, height=32, aa_samples=2)
    return s.compile(device="cpu"), cfg


def _save(out: str, name: str, rank: int, film: dict, stats=None) -> None:
    np.savez(os.path.join(out, f"{name}.{rank}.npz"),
             **{k: np.asarray(v.cpu() if torch.is_tensor(v) else v)
                for k, v in film.items()})
    if stats is not None:
        keep = {k: stats[k] for k in ("rays", "rank_rays", "mesh",
                                      "pass_log", "reduce_s",
                                      "lanes_traced") if k in stats}
        with open(os.path.join(out, f"{name}.{rank}.json"), "w") as f:
            json.dump(keep, f)


def _rank_cases(rank: int, out: str, film_path: str) -> None:
    """One rank of the fixture's group: every case, the mesh API, the
    photon maps; then rank 1 dies while rank 0 waits for it."""
    for name in RENDERS:
        res = render_scene(_scene(name.removesuffix("_timed")), device="cpu",
                           timed=name.endswith("_timed"),
                           film_path=film_path if name == "resume" else None)
        _save(out, name, rank, res.film, res.stats)
    cs, cfg = _small_scene()
    _save(out, "render_sharded_global", rank,
          pd.render_sharded_global(cs, cfg, device="cpu"))
    s = _scene("photonmapping")
    cs = s.compile(device="cpu")
    maps = build_photon_maps(cs, build_config(s),
                             to_tensors(cs.arrays, "cpu"),
                             mesh=make_device_mesh(height=16, device="cpu"))
    _save(out, "photon_maps", rank, _flat_packs(maps))
    pd.barrier()  # every file written
    if rank == 1:
        with open(os.path.join(out, "dead_at"), "w") as f:
            f.write(repr(time.time()))
        os._exit(DEAD_EXIT)
    pd.barrier()


def _flat_packs(maps: dict) -> dict:
    return {f"{m}.{k}": v for m in ("diffuse", "caustic", "radiance")
            if maps[m] is not None for k, v in maps[m].items()
            if torch.is_tensor(v)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The group's films (rank files under `dir`), the exception the
    parent raised when rank 1 died, and when it raised."""
    out = str(tmp_path_factory.mktemp("ranks"))
    # the ranks resume from pass1.npz and rank 0 saves over it; the
    # one-process render resumes from the copy pass1_orig.npz
    film_path = os.path.join(out, "pass1.npz")
    shutil.copy(_pass1_film(tmp_path_factory.mktemp("film")), film_path)
    shutil.copy(film_path, os.path.join(out, "pass1_orig.npz"))
    failure = None
    # the reference's sharded render compiles in this process while the
    # ranks render (one torch thread each)
    with ThreadPoolExecutor(1) as pool:
        reference = pool.submit(_reference_sharded)
        try:
            pd.spawn_ranks(_rank_cases, 2, (out, film_path), device="cpu",
                           threads=1, timeout_s=GROUP_TIMEOUT_S)
        except (ProcessRaisedException, ProcessExitedException) as e:
            failure = e
        raised_at = time.time()
    return dict(dir=out, failure=failure, raised_at=raised_at,
                reference=reference.result())


def _reference_sharded() -> tuple:
    """(image, rays) of the reference's render_sharded on a 2-device mesh
    at tests/test_parallel.py's small_scene (cornell.xml, 32², 2 spp,
    pathtracing, bounces 2)."""
    import jax.numpy as jnp

    from libyafaray_tpu.integrators.config import RenderConfig as RefConfig
    from libyafaray_tpu.parallel.mesh import make_device_mesh as ref_mesh
    from libyafaray_tpu.parallel.mesh import render_sharded as ref_sharded
    from libyafaray_tpu.scene.session import build_config as ref_build
    from libyafaray_tpu.scene.xml_parser import parse_xml_file as ref_parse

    s = ref_parse(os.path.join(SCENES, "cornell.xml"))
    s.render_params["width"] = 32
    s.render_params["height"] = 32
    cfg = ref_build(s)
    cfg = RefConfig(**{**cfg.__dict__, "integrator": "pathtracing",
                       "bounces": 2, "width": 32, "height": 32,
                       "aa_samples": 2})
    ref = ref_sharded(s.compile(), cfg, ref_mesh(2), n_steps=2)
    return (np.asarray(ref["wsum"] / jnp.maximum(ref["w"], 1e-8)[..., None]),
            float(ref["rays"]))


def _pass1_film(d) -> str:
    """The resume case's film as one process saves it after pass 1 of 2
    (copied while pass 2's progress is reported, before its save)."""
    path, copy = str(d / "film.npz"), str(d / "pass1.npz")
    s = _scene("resume")

    def grab(p, total):
        if p == 2:
            shutil.copy(path, copy)

    with _threads(1):
        render_scene(s, device="cpu", film_path=path, progress_cb=grab)
    return copy


class _threads:
    def __init__(self, n: int):
        self.n = n

    def __enter__(self):
        self.old = torch.get_num_threads()
        torch.set_num_threads(self.n)

    def __exit__(self, *exc):
        torch.set_num_threads(self.old)


def _load(ranks, name: str, rank: int):
    path = os.path.join(ranks["dir"], f"{name}.{rank}")
    film = dict(np.load(path + ".npz"))
    stats = None
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            stats = json.load(f)
    return film, stats


def _image(film: dict) -> np.ndarray:
    return pfilm.film_image({k: torch.from_numpy(v) for k, v in film.items()
                             }).numpy()


@pytest.mark.parametrize("name", RENDERS)
def test_sharded_render_matches_one_process(ranks, name, tmp_path):
    """Both ranks return the same full film; it matches the one-process
    render of the same call (timed or not) within the case's bound, rays
    within 1, and the ranks' own rays sum to the one-process count; each
    rank traced only its band: the lanes its steps ran sum over the ranks
    to the one-process lanes (pass 0's under adaptive passes, whose
    compact buckets are per band).  The resumed film: rank 0 saved the
    summed film, as one process saves its own."""
    case = name.removesuffix("_timed")
    s = _scene(case)
    film_path = None
    if name == "resume":
        film_path = str(tmp_path / "pass1.npz")
        shutil.copy(os.path.join(ranks["dir"], "pass1_orig.npz"), film_path)
    with _threads(1):
        one = render_scene(s, device="cpu", film_path=film_path,
                           timed=name != case)
    f0, st0 = _load(ranks, name, 0)
    f1, st1 = _load(ranks, name, 1)
    for k in f0:
        np.testing.assert_array_equal(f0[k], f1[k], err_msg=k)
    bound = CASES[case][3]
    img = _image(f0)
    assert np.isfinite(img).all()
    np.testing.assert_allclose(img, one.image, rtol=0, atol=bound)
    assert abs(st0["rays"] - one.stats["rays"]) < 1.0
    if name != "resume":  # the loaded rays ride on rank 0's partial
        assert abs(st0["rank_rays"] + st1["rank_rays"]
                   - one.stats["rays"]) < 1.0
    h = s.render_params["height"]
    assert [tuple(st["mesh"]["rows"]) for st in (st0, st1)] == [
        band_rows(h, 2, 0), band_rows(h, 2, 1)]
    if case == "bidirectional":
        d = f0["density"].astype(np.float64) - one.film["density"].numpy()
        assert float(np.sqrt(np.mean(d ** 2))) <= 1e-5
    if name == "resume":
        saved = dict(np.load(os.path.join(ranks["dir"], "pass1.npz")))
        mine = dict(np.load(film_path))
        assert int(saved["__pass__"]) == int(mine["__pass__"]) == 2
        np.testing.assert_allclose(saved["wsum"], mine["wsum"], rtol=0,
                                   atol=bound)
    if st0.get("pass_log"):
        w = s.render_params["width"]
        first = [st["pass_log"][0]["lanes"] for st in (st0, st1)]
        assert first == [(r1 - r0) * w for r0, r1 in (
            band_rows(h, 2, 0), band_rows(h, 2, 1))]
        assert sum(first) == one.stats["pass_log"][0]["lanes"]
    if "AA_passes" not in CASES[case][1]:
        assert st0["lanes_traced"] + st1["lanes_traced"] == \
            one.stats["lanes_traced"] > 0


def test_photon_packs_bit_equal(ranks):
    """build_photon_maps over the mesh: the stored photons gathered in lane
    order give every rank the one-process packs, bit for bit."""
    s = _scene("photonmapping")
    cs = s.compile(device="cpu")
    with _threads(1):
        one = _flat_packs(build_photon_maps(cs, build_config(s),
                                            to_tensors(cs.arrays, "cpu")))
    for rank in (0, 1):
        packs, _ = _load(ranks, "photon_maps", rank)
        assert sorted(packs) == sorted(one)
        for k, v in one.items():
            np.testing.assert_array_equal(packs[k], v.numpy(), err_msg=k)


def test_render_sharded_global_on_every_rank(ranks):
    """render_sharded_global returns the full host planes on both ranks,
    the same on each, matching the one-process steps."""
    from libyafaray_tpu_torch.integrators.engine import make_sample_step
    from libyafaray_tpu_torch.integrators.render import _fresh_film

    cs, cfg = _small_scene()
    step = make_sample_step(cs.static, cs.camera, cfg, "cpu")
    arrays = to_tensors(cs.arrays, "cpu")
    film = _fresh_film(cfg, "cpu")
    flags = torch.ones((cfg.height, cfg.width), dtype=torch.bool)
    with _threads(1):
        for _ in range(cfg.aa_samples):
            film = step(arrays, film, flags)
    g0, _ = _load(ranks, "render_sharded_global", 0)
    g1, _ = _load(ranks, "render_sharded_global", 1)
    assert sorted(g0) == sorted(film)
    for k in g0:
        np.testing.assert_array_equal(g0[k], g1[k], err_msg=k)
    np.testing.assert_allclose(_image(g0), pfilm.film_image(film).numpy(),
                               rtol=0, atol=1e-5)
    assert abs(float(g0["rays"]) - float(film["rays"])) < 1.0


def test_sharded_slice_matches_reference(ranks):
    """The port's 2-rank render_sharded against the reference's
    render_sharded on a 2-device mesh (tests/test_parallel.py's
    small_scene, rendered by the fixture): image atol 1e-5, rays within
    1."""
    ref_img, ref_rays = ranks["reference"]
    port, _ = _load(ranks, "render_sharded_global", 0)
    np.testing.assert_allclose(_image(port), ref_img, rtol=0, atol=1e-5)
    assert abs(float(port["rays"]) - ref_rays) < 1.0


def test_dead_rank_fails_the_run(ranks):
    """Rank 1 exits after its renders while rank 0 waits for it: the
    parent raises, naming the dead rank's exit, within a few seconds and
    well inside the group's timeout, after every case was written."""
    err = ranks["failure"]
    assert err is not None
    if isinstance(err, ProcessExitedException):
        assert err.error_index == 1 and err.exit_code == DEAD_EXIT
    with open(os.path.join(ranks["dir"], "dead_at")) as f:
        dead_at = float(f.read())
    assert ranks["raised_at"] - dead_at < GROUP_TIMEOUT_S / 4
    for name in RENDERS + ["render_sharded_global", "photon_maps"]:
        for rank in (0, 1):
            assert os.path.exists(os.path.join(ranks["dir"],
                                               f"{name}.{rank}.npz")), name


# ---- no processes ------------------------------------------------------------


@pytest.mark.parametrize("requested, height", [
    (None, 16), (1, 16), (2, 16), (3, 16), (5, 15), (8, 12), (7, 7),
    (16, 16)])
def test_device_count_rule_and_bands(requested, height):
    """auto_devices keeps the reference session's `_auto_mesh` rule (8
    virtual devices here): None takes all, N is clamped, then lowered to a
    divisor of the height; the bands split the rows in order."""
    from libyafaray_tpu.scene.session import _auto_mesh

    ref = _auto_mesh(None, height, requested)
    want = 1 if ref is None else ref.devices.size
    n = auto_devices(requested, height, 8)
    assert n == want
    bands = [band_rows(height, n, r) for r in range(n)]
    assert bands[0][0] == 0 and bands[-1][1] == height
    assert all(a[1] == b[0] for a, b in zip(bands, bands[1:]))
    assert len({r1 - r0 for r0, r1 in bands}) == 1


def test_cpu_device_rule():
    """On the CPU None renders in this process alone; N ranks are taken up
    to the cores, lowered to a divisor of the height."""
    cores = os.cpu_count() or 1
    assert n_devices_for(None, "cpu", 16) == 1
    assert n_devices_for(3, "cpu", 16) == (2 if cores >= 2 else 1)
    assert n_devices_for(1, "cpu", 16) == 1
    assert make_device_mesh(height=16, device="cpu").world == 1
    with pytest.raises(ValueError, match="no process group"):
        make_device_mesh(2, height=16, device="cpu")


def test_plane_table_against_film_shardings_for():
    """Every film plane the reference shards by rows is one the port's
    ranks fill by band and sum; its replicated scalar is the port's summed
    ray counter."""
    from jax.sharding import PartitionSpec as P

    from libyafaray_tpu.film.imagefilm import film_init as ref_film_init
    from libyafaray_tpu.film.passes import film_add_passes as ref_add
    from libyafaray_tpu.parallel.mesh import film_shardings_for as ref_table
    from libyafaray_tpu.parallel.mesh import make_device_mesh as ref_mesh

    passes = tuple(p for p in PASS_NAMES if p != "combined")
    ref = ref_add(ref_film_init(4, 4, with_density=True, with_alpha=True,
                                with_variance=True), 4, 4, passes)
    import jax.numpy as jnp

    ref["rays"] = jnp.zeros((), jnp.float32)
    port = film_add_passes(pfilm.film_init(4, 4, "cpu", with_density=True,
                                           with_alpha=True,
                                           with_variance=True), 4, 4, passes,
                           "cpu")
    port["rays"] = torch.zeros(())
    # the reference's film carries its flags plane; the port passes the
    # flags beside the film
    assert sorted(port) == sorted(k for k in ref if k != "flags")
    table = film_shardings_for(port)
    for k, sh in ref_table(ref, ref_mesh(2)).items():
        if k == "flags":
            continue
        if sh.spec == P():
            assert table[k] == "sum", k
        else:
            assert sh.spec[0] == "film" and table[k] == "rows", k
    for k in ("wsum", "w", "nsamples", "alpha", "m2", "density"):
        assert table[k] == "rows"
