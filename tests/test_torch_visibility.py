"""Object visibility (normal, invisible, shadow_only, no_shadows) against
the reference, on tests/test_visibility.py's scene (a floor, an occluder
quad between it and a point light):
- the compile of all four variants: the visible / shadow set split and
  their real counts, the all-normal alias, and every array the port's
  compile builds equal to the reference's; the shadow set's sub-cluster
  and 32-column box tables equal the port's tables built from its own
  pack (stri_pack10), and convert.arrays_from_reference builds the same;
- the shadow_only variant rendered by both packages at 16², 4 spp
  (directlighting): image RMSE <= 1e-4, rays equal;
- the port's own four renders at the reference test's 48², held to that
  test's assertions.
"""
import numpy as np
import pytest
import torch

from libyafaray_tpu.scene.session import render_scene as ref_render_scene
from libyafaray_tpu.scene.xml_parser import parse_xml_string as ref_parse
from libyafaray_tpu_torch import convert
from libyafaray_tpu_torch.ops.cluster_intersect import quarter_boxes
from libyafaray_tpu_torch.ops.fine_intersect import sub_aabbs
from libyafaray_tpu_torch.scene.session import render_scene
from libyafaray_tpu_torch.scene.xml_parser import parse_xml_string
from test_visibility import _scene_xml

VARIANTS = ("normal", "invisible", "shadow_only", "no_shadows")
# the shadow set's tables the port builds (the reference derives its own in
# its kernels' wrappers)
PORT_ONLY = ("tri_sub8", "stri_sub8", "tri_box32", "stri_box32")


def _equal_tree(port, ref, name):
    if isinstance(port, dict):
        for k in port:
            _equal_tree(port[k], ref[k], f"{name}.{k}")
        return
    np.testing.assert_array_equal(np.asarray(port), np.asarray(ref),
                                  err_msg=name)


@pytest.mark.parametrize("vis", VARIANTS)
def test_compile_set_split(vis):
    ref = ref_parse(_scene_xml(vis)).compile()
    port = parse_xml_string(_scene_xml(vis)).compile(device="cpu")
    counts = {"normal": (4, 4), "shadow_only": (2, 4),
              "no_shadows": (4, 2), "invisible": (2, 2)}[vis]
    assert (port.static.n_tris_real, port.static.n_stris_real) == counts
    assert (ref.static.n_tris_real, ref.static.n_stris_real) == counts
    if vis == "normal":  # the shadow packs alias the visible packs
        assert port.arrays["tri_pack10"] is port.arrays["stri_pack10"]
        assert port.arrays["tri_sub8"] is port.arrays["stri_sub8"]
    for k, v in port.arrays.items():
        if k not in PORT_ONLY:
            _equal_tree(v, ref.arrays[k], k)
    ns = port.static.n_stris_real
    np.testing.assert_array_equal(port.arrays["stri_sub8"],
                                  sub_aabbs(port.arrays["stri_pack10"], ns))
    np.testing.assert_array_equal(port.arrays["stri_box32"],
                                  quarter_boxes(port.arrays["stri_pack10"],
                                                ns))
    conv = convert.arrays_from_reference(ref.arrays, "cpu",
                                         n_stris_real=ref.static.n_stris_real)
    for k in PORT_ONLY:
        np.testing.assert_array_equal(conv[k].numpy(), port.arrays[k],
                                      err_msg=k)
    assert convert.static_from_reference(ref.static).n_stris_real == ns


def test_shadow_only_matches_reference():
    xml = _scene_xml("shadow_only").replace(
        '<width ival="48"/><height ival="48"/>',
        '<width ival="16"/><height ival="16"/>')
    ref = ref_render_scene(ref_parse(xml))
    port = render_scene(parse_xml_string(xml), device="cpu")
    img = port.image
    assert img.shape == (16, 16, 3)
    rmse = float(np.sqrt(np.mean((img - np.asarray(ref.image)) ** 2)))
    assert rmse <= 1e-4, rmse
    assert port.stats["rays"] == float(ref.stats["rays"])


@pytest.fixture(scope="module")
def images():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {vis: render_scene(parse_xml_string(_scene_xml(vis)),
                             device="cpu").image for vis in VARIANTS}
    torch.set_num_threads(n)
    return out


def _center_mean(img):
    h, w, _ = img.shape
    return img[h // 2 - 4:h // 2 + 4, w // 2 - 4:w // 2 + 4].mean()


def test_visibility_semantics(images):
    """tests/test_visibility.py's assertions on the port's renders."""
    assert _center_mean(images["normal"]) < 0.05
    assert _center_mean(images["shadow_only"]) < 0.05
    assert _center_mean(images["invisible"]) > 0.5
    assert _center_mean(images["no_shadows"]) > 0.5
    assert images["shadow_only"].mean() < 0.9 * images["invisible"].mean()
    assert images["normal"].mean() < 0.9 * images["no_shadows"].mean()
    assert np.abs(images["normal"] - images["shadow_only"]).max() > 0.05
    assert np.abs(images["no_shadows"] - images["invisible"]).max() > 0.05
    h = images["normal"].shape[0]
    sl = np.s_[h // 2 - 2:h // 2 + 2, h // 2 - 2:h // 2 + 2]
    assert np.allclose(images["normal"][sl], images["shadow_only"][sl],
                       atol=1e-5)
