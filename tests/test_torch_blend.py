"""Blend and mask materials in the port against the JAX reference on the
CPU: tests/test_textures.py's 32x32 directlighting floor scenes (a
UV-mapped quad under a white constant background with IBL, 4 samples) with
a mask material whose mask is a texture and a blend nested in a blend
whose factor is a texture (the textures re-applied to a composite's
children at every level).  The image is the reference's (RMSE <= 1e-4)
and the mapped factor picks the red child on the left and the blue one on
the right."""
import numpy as np
import pytest
import torch

from libyafaray_tpu.scene.params import ParamMap as RefParamMap
from libyafaray_tpu_torch.scene.params import ParamMap


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _floor_scene(scene_cls, pmap, materials_fn, floor_mat, render_fn):
    """tests/test_textures.py's 32x32 directlighting scene: a UV-mapped
    floor quad under a white constant background with IBL (4 samples)."""
    s = scene_cls()
    materials_fn(s, pmap)
    s.create_background("bg", pmap({"type": "constant",
                                    "color": (1.0, 1.0, 1.0),
                                    "ibl": True, "ibl_samples": 4}))
    s.start_tri_mesh(1, has_uv=True, visibility="normal")
    for (x, y), (u, v) in zip(((-2, -2), (2, -2), (2, 2), (-2, 2)),
                              ((0, 0), (1, 0), (1, 1), (0, 1))):
        s.add_vertex(x, y, 0.0)
        s.add_uv(u, v)
    fm = s.material_names[floor_mat]
    s.add_triangle(0, 1, 2, fm, 0, 1, 2)
    s.add_triangle(0, 2, 3, fm, 0, 2, 3)
    s.end_tri_mesh()
    s.create_camera("cam", pmap({
        "type": "perspective", "resx": 32, "resy": 32,
        "from": (0.0, 0.0, 4.0), "to": (0.0, 0.001, 0.0),
        "up": (0.0, 1.0, 4.0), "focal": 1.0}))
    s.create_integrator("default", pmap({"type": "directlighting",
                                         "raydepth": 1}))
    s.set_render_params(pmap({"width": 32, "height": 32,
                              "AA_minsamples": 8, "camera_name": "cam",
                              "integrator_name": "default"}))
    return render_fn(s).image


def _mask_mats(s, pmap, nested=False):
    s.create_texture("gtex", pmap({"type": "blend", "stype": "lin"}))
    node = pmap({"name": "m0", "type": "texture_mapper", "texture": "gtex",
                 "texco": "uv"})
    s.create_material("red", pmap({"type": "shinydiffusemat",
                                   "color": (1.0, 0.0, 0.0)}))
    s.create_material("blue", pmap({"type": "shinydiffusemat",
                                    "color": (0.0, 0.0, 1.0)}))
    if not nested:
        s.create_material("m", pmap({
            "type": "mask_mat", "material1": "red", "material2": "blue",
            "threshold": 0.5, "mask_shader": "m0", "__list__": [node]}))
        return
    s.create_material("inner", pmap({
        "type": "blend_mat", "material1": "red", "material2": "blue",
        "blend_value": 0.5, "blend_shader": "m0", "__list__": [node]}))
    s.create_material("green", pmap({"type": "shinydiffusemat",
                                     "color": (0.0, 1.0, 0.0)}))
    s.create_material("m", pmap({"type": "blend_mat", "material1": "inner",
                                 "material2": "green", "blend_value": 0.0}))


@pytest.mark.parametrize("nested, ratio", [(False, 3.0), (True, 2.0)])
def test_mask_and_nested_blend_match_reference(nested, ratio):
    """test_mask_material_texture_switches (nested=False) and
    test_nested_blend_shader_mapped_factor (nested=True) in the port: the
    mapped factor picks the red child on the left and the blue one on the
    right, and the image is the reference's (RMSE <= 1e-4)."""
    from libyafaray_tpu.scene.scene import Scene as RefScene
    from libyafaray_tpu.scene.session import render_scene as ref_render
    from libyafaray_tpu_torch.scene.scene import Scene
    from libyafaray_tpu_torch.scene.session import render_scene

    def mats(s, pmap):
        _mask_mats(s, pmap, nested)

    img = _floor_scene(Scene, ParamMap, mats, "m",
                       lambda s: render_scene(s, device="cpu"))
    ref = _floor_scene(RefScene, RefParamMap, mats, "m", ref_render)
    left = img[12:20, 2:8].mean(axis=(0, 1))
    right = img[12:20, 24:30].mean(axis=(0, 1))
    assert left[0] > ratio * max(left[2], 1e-6), (left, right)
    assert right[2] > ratio * max(right[0], 1e-6), (left, right)
    assert float(np.sqrt(np.mean((img - np.asarray(ref)) ** 2))) <= 1e-4
