"""The port's non-local-means denoise (libyafaray_tpu_torch/film/denoise.py)
against the JAX reference's (libyafaray_tpu/film/denoise.py), op by op
and compiled, on a seeded noisy 32² image: the default strengths and mix,
both strengths 0 (every band kept), mix 0 (the original image) and a
luminance-only setting, atol 1e-5.  The host entry point defaults to the
card and raises without one; as in the reference, no render path calls
the denoise."""
import inspect

import numpy as np
import pytest
import torch

from libyafaray_tpu.film import denoise as ref_denoise
from libyafaray_tpu_torch.film.denoise import denoise_image, nlm_denoise


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU path is many small tensor ops: one thread runs them
    fastest (and keeps parallel test workers off each other's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

SETTINGS = [(5.0, 5.0, 0.8), (0.0, 0.0, 0.8), (5.0, 5.0, 0.0),
            (3.0, 0.0, 1.0)]


def _noisy(size=32, seed=11):
    rng = np.random.default_rng(seed)
    ramp = np.linspace(0.0, 1.0, size, dtype=np.float32)
    img = np.stack([ramp[None, :].repeat(size, 0),
                    ramp[:, None].repeat(size, 1),
                    np.full((size, size), 0.4, np.float32)], axis=-1)
    img[size // 4:size // 2, size // 4:size // 2] = 0.9  # an edge
    return np.clip(img + rng.normal(0.0, 0.08, img.shape), 0.0,
                   None).astype(np.float32)


@pytest.mark.parametrize("h_lum, h_col, mix", SETTINGS)
def test_nlm_matches_reference(h_lum, h_col, mix):
    img = _noisy()
    port = nlm_denoise(torch.from_numpy(img), h_lum, h_col, mix).numpy()
    eager = np.asarray(ref_denoise.nlm_denoise(img, h_lum, h_col, mix))
    jitted = ref_denoise.denoise_image(img, h_lum, h_col, mix)
    np.testing.assert_allclose(port, eager, atol=1e-5)
    np.testing.assert_allclose(port, jitted, atol=1e-5)
    host = denoise_image(img, h_lum, h_col, mix, device="cpu")
    assert isinstance(host, np.ndarray) and np.array_equal(host, port)
    if mix == 0.0:
        np.testing.assert_allclose(port, img, atol=1e-6)
    if mix > 0.0 and h_lum > 0.0 and h_col > 0.0:
        # the noise is smoothed
        assert np.abs(np.diff(port, axis=1)).mean() < np.abs(
            np.diff(img, axis=1)).mean()


def test_denoise_entry_defaults_to_the_card():
    assert inspect.signature(denoise_image).parameters["device"].default \
        == "cuda"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        denoise_image(_noisy(8))
