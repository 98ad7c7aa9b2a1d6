"""The cascaded scene of the reference snapshot tester in the port against
impact_tpu's frame on the CPU (the third frame of
``tests/test_torch_parity_scenes_frames.py``, in a file of its own so that
``--dist loadfile`` spreads the frames): SoftCascadedShadowMapping, four
soft cascades, at 128x96 with 64² maps, no raster drops, at least 0.95
against the reference's frame."""

from test_torch_chunked_engine import few_torch_threads  # noqa: F401  (an autouse fixture)
from test_torch_parity_scenes_frames import check_frame


def test_soft_cascaded_frame_matches_reference(monkeypatch):
    check_frame("SoftCascadedShadowMapping", monkeypatch)
