"""The IBL light in SPPM, the port against the JAX reference on the CPU:
tests/test_torch_ibl_photon.py's scene (ibl_spheres.xml with an area
light added) at 16², 2 passes, 4,096 photons a pass, raydepth 3: the
photon pass shoots the area light's photons only (the IBL light's flux is
zero), the eye pass takes NEE from both lights.  Image RMSE <= 1e-4, rays
within 0.01% (tests/test_torch_sppm.py's bounds)."""
import pytest
import torch

from test_torch_ibl_photon import REPO, match_reference


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def repo_cwd(monkeypatch):
    """The scene names its assets relative to the repository root."""
    monkeypatch.chdir(REPO)


def test_ibl_sppm_matches_reference():
    match_reference("SPPM")
