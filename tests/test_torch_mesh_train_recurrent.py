"""The train step under a (data, model) mesh against the reference's
single-device step (``test_torch_mesh_train.py``'s check and bounds) for
rwkv6-3b (K5 on each rank's rows and heads), recurrentgemma-9b (K6 on
its rows and channels, K3 with one kv head replicated over model) and
qwen2-vl-2b (M-RoPE positions split on their batch axis, the vision
stub)."""
import pytest

from test_torch_mesh_train import MESHES, check, run_archs

ARCHS = ("rwkv6-3b", "recurrentgemma-9b", "qwen2-vl-2b")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_archs(ARCHS, tmp_path_factory.mktemp("mesh_train_rec"))


@pytest.mark.parametrize("mesh", [f"{a}x{b}" for a, b in MESHES])
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_step_matches_reference(results, arch, mesh):
    check(results, arch, mesh)
