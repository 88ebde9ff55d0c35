"""The train step under a (data, model) mesh against the reference's
single-device step (``test_torch_mesh_train.py``'s check and bounds) for
the MoE configurations (granite-moe-3b-a800m; arctic-480b, its dense
residual beside the experts and Adafactor's state replicated) and
musicgen-large's audio codebooks.  Each rank routes its own rows and
runs the experts it holds through K4 (``models.mlp._moe_on_mesh``)."""
import pytest

from test_torch_mesh_train import MESHES, check, run_archs

ARCHS = ("granite-moe-3b-a800m", "arctic-480b", "musicgen-large")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_archs(ARCHS, tmp_path_factory.mktemp("mesh_train_moe"))


@pytest.mark.parametrize("mesh", [f"{a}x{b}" for a, b in MESHES])
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_step_matches_reference(results, arch, mesh):
    check(results, arch, mesh)
