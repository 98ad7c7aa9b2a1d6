"""The snapshot tester's remaining scenes through the port's runner on the
CPU, each frame against its committed golden at ≥ 0.93 (part 3 of 3 of the
snapshot tests; parts 1 and 2 hold the scene compile, PNG reading, shadows
and the other frames). The frame is the runner's, through K1 (its plain
version on the CPU); the scenes step the default ``scan`` solver."""

import pytest
from test_torch_chunked_engine import few_torch_threads  # noqa: F401  (an autouse fixture)
from test_torch_snapshot_scenes import check_frame


@pytest.mark.parametrize("name", [
    "VoxelBoxTumbler", "Asteroid", "Fracturing", "AmbientLight", "OmnidirectionalLight",
    "UnidirectionalLight", "ShadowableOmnidirectionalLight", "ShadowableUnidirectionalLight",
    "AmbientOcclusion", "Bloom", "ACESToneMapping", "KhronosPBRNeutralToneMapping"])
def test_frame_matches_golden(name):
    check_frame(name)
