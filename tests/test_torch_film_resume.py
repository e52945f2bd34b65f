"""Film save / load and autosave in the port (film/imagefilm.py film_save /
film_load, the render loops of integrators/render.py, photonmap.py,
sppm.py and veach.py).

A render killed mid-way (its progress callback raises after a pass, so the
film saved after the pass before it is on disk) and resumed under
film_save_load "load-save" ends with the film of the same render run
straight through: every plane equal under the path tracer (3 adaptive
passes, with pass and alpha planes), photon mapping (2 passes) and SPPM
(4 passes of 8,192 photons at 32², the reference's
tests/test_cli.py::test_sppm_kill_resume set-up, and its bound: image
within 1e-4), and under BDPT (3 steps) the eye-side planes equal and the
t=1 density plane within RMSE 1e-5.  Autosave by time writes the film
with the pass it is in.  The file layout is the reference's: a film the
port saves reads back through the reference's film_load with the same
params, and a film the reference saves through the port's; a film saved
under other params, or no file, loads as None.
"""
import os
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libyafaray_tpu.film import imagefilm as ref_film
from libyafaray_tpu_torch.film.imagefilm import (film_load, film_param_hash,
                                                 film_save)
from libyafaray_tpu_torch.integrators import photonmap, render as rmod
from libyafaray_tpu_torch.integrators import sppm, veach
from libyafaray_tpu_torch.scene.session import build_config
from libyafaray_tpu_torch.scene.xml_parser import parse_xml_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(REPO, "scenes")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Killed(Exception):
    pass


def _scene(name, size, **over):
    s = parse_xml_file(os.path.join(SCENES, name))
    s.render_params["width"] = s.render_params["height"] = size
    cfg = replace(build_config(s), width=size, height=size, **over)
    return s.compile(device="cpu"), cfg


def _kill_and_resume(run, cfg, path, kill_at):
    """run(cfg, film_path, progress_cb) killed after pass (step) kill_at,
    then run again from the film saved before it."""
    def kill(p, total):
        if p == kill_at:
            raise Killed

    with pytest.raises(Killed):
        run(cfg, path, kill)
    data = np.load(path)
    assert int(data["__pass__"]) == kill_at - 1
    done = []
    out = run(cfg, path, lambda p, total: done.append(p))
    return out, done


def _films_equal(a: dict, b: dict, skip=()):
    assert set(a) == set(b)
    for k in a:
        if k not in skip:
            assert torch.equal(a[k], b[k]), k


def test_render_resumes_to_the_straight_film(tmp_path):
    cs, cfg = _scene("cornell.xml", 16, integrator="pathtracing",
                     bounces=2, aa_samples=2, aa_passes=3, aa_inc_samples=1,
                     aa_threshold=0.05, transp_background=True,
                     passes=("z-depth-abs", "direct", "ao", "reflect"),
                     film_save_load="load-save")
    straight = rmod.render(cs, cfg, device="cpu")
    path = str(tmp_path / "film.npz")
    resumed, done = _kill_and_resume(
        lambda c, f, cb: rmod.render(cs, c, device="cpu", film_path=f,
                                     progress_cb=cb), cfg, path, 2)
    assert done == [2, 3]
    _films_equal(straight.film, resumed.film)
    assert {"alpha", "aov_z", "aov_direct", "aov_ao",
            "aov_reflect"} <= set(resumed.film)
    assert int(np.load(path)["__pass__"]) == 3


def test_time_autosave_writes_the_pass_in_progress(tmp_path):
    cs, cfg = _scene("cornell.xml", 8, integrator="pathtracing", bounces=1,
                     aa_samples=2, aa_passes=2, aa_inc_samples=1,
                     aa_threshold=0.0, autosave_interval_type="time",
                     autosave_interval=0.0)
    path = str(tmp_path / "auto.npz")
    res = rmod.render(cs, cfg, device="cpu", film_path=path)
    data = np.load(path)
    assert int(data["__pass__"]) == 1  # saved mid-pass, before it ended
    assert np.array_equal(data["nsamples"], res.film["nsamples"].numpy())
    assert data["nsamples"].dtype == np.int32 and data["rays"].shape == ()


def test_photonmap_resumes_to_the_straight_film(tmp_path):
    cs, cfg = _scene("cornell_photon.xml", 16, photons=4096,
                     caustic_photons=2048, fg_samples=2, aa_samples=1,
                     aa_passes=2, aa_inc_samples=1,
                     film_save_load="load-save")
    straight = photonmap.render_photonmap(cs, cfg, device="cpu")
    path = str(tmp_path / "pm.npz")
    resumed, done = _kill_and_resume(
        lambda c, f, cb: photonmap.render_photonmap(
            cs, c, device="cpu", film_path=f, progress_cb=cb), cfg, path, 2)
    assert done == [2]
    _films_equal(straight.film, resumed.film)


def test_sppm_resumes_to_the_straight_film(tmp_path):
    cs, cfg = _scene("cornell_sppm.xml", 32, sppm_photons=8192,
                     sppm_passes=4, aa_samples=1, aa_passes=1,
                     film_save_load="load-save")
    straight = sppm.render_sppm(cs, cfg, device="cpu")
    path = str(tmp_path / "sppm.npz")
    resumed, done = _kill_and_resume(
        lambda c, f, cb: sppm.render_sppm(cs, c, device="cpu", film_path=f,
                                          progress_cb=cb), cfg, path, 3)
    assert done == [3, 4]
    assert resumed.stats["photons"]["emitted"] == \
        straight.stats["photons"]["emitted"]
    assert np.abs(resumed.image - straight.image).max() < 1e-4
    _films_equal(straight.film, resumed.film)
    data = np.load(path)
    assert {"sppm_r2", "sppm_n", "sppm_tau", "sppm_nem"} <= set(data.files)


def test_bdpt_resumes_to_the_straight_film(tmp_path):
    cs, cfg = _scene("cornell_bidir.xml", 8, aa_samples=3, aa_passes=1,
                     passes=("z-depth-abs", "normal-smooth"),
                     film_save_load="load-save")
    straight = veach.render_bdpt(cs, cfg, device="cpu")
    path = str(tmp_path / "bd.npz")
    resumed, done = _kill_and_resume(
        lambda c, f, cb: veach.render_bdpt(cs, c, device="cpu", film_path=f,
                                           progress_cb=cb), cfg, path, 2)
    assert done == [2, 3]
    _films_equal(straight.film, resumed.film, skip=("density",))
    d = (resumed.film["density"] - straight.film["density"]).numpy()
    assert float(np.sqrt(np.mean(d * d))) <= 1e-5
    assert "bd_splat" in np.load(path).files


def test_port_film_reads_in_the_reference(tmp_path):
    cs, cfg = _scene("cornell.xml", 8, integrator="pathtracing", bounces=1,
                     aa_samples=1, transp_background=True,
                     passes=("z-depth-abs",))
    film = rmod.render(cs, cfg, device="cpu").film
    path = str(tmp_path / "port.npz")
    params = {"cfg": repr(cfg)}
    film_save(path, film, params, 7)
    loaded = ref_film.film_load(path, params)
    assert loaded is not None and loaded[1] == 7
    assert set(loaded[0]) == set(film)
    for k, v in film.items():
        got = np.asarray(loaded[0][k])
        assert got.dtype == v.numpy().dtype and np.array_equal(got,
                                                               v.numpy()), k
    assert ref_film.film_param_hash(params) == film_param_hash(params)
    assert ref_film.film_load(path, {"cfg": "other"}) is None


def test_reference_film_reads_in_the_port(tmp_path):
    film = ref_film.film_init(4, 5, with_alpha=True)
    film["wsum"] = jnp.full((4, 5, 3), 2.5, jnp.float32)
    film["w"] = jnp.full((4, 5), 2.0, jnp.float32)
    film["nsamples"] = jnp.full((4, 5), 3, jnp.int32)
    film["rays"] = jnp.asarray(123.0, jnp.float32)
    path = str(tmp_path / "ref.npz")
    ref_film.film_save(path, film, {"cfg": "X"}, pass_idx=2)
    loaded = film_load(path, {"cfg": "X"}, "cpu")
    assert loaded is not None and loaded[1] == 2
    port, _ = loaded
    assert set(port) == set(film)
    for k, v in film.items():
        v = np.asarray(v)
        assert port[k].device.type == "cpu"
        assert port[k].numpy().dtype == v.dtype
        assert np.array_equal(port[k].numpy(), v), k
    assert port["rays"].shape == () and port["nsamples"].dtype == torch.int32
    assert film_load(path, {"cfg": "Y"}, "cpu") is None
    assert film_load(str(tmp_path / "none.npz"), {"cfg": "X"}, "cpu") is None
