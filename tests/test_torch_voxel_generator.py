"""The port's voxel generator (``impact_tpu_torch/apps/voxel_generator.py``)
against the reference package's app (``apps/voxel_generator.py``) on the
CPU.

* ``example`` writes the same graph file in both apps, and each app loads
  the other's.
* ``stats`` of the example graph and of a meta graph (lowered at seed 0, as
  both apps lower it) prints the same line in both: solid voxels, vertices
  and triangles of the 48³ grid of 0.5-unit voxels.
* ``preview`` of the example graph on the CPU (K1's plain version) scores
  at least 0.95 (``rgb_hybrid_compare``, the repo's parity bar) against the
  reference app's PNG of the same graph, and at least 0.95 against the
  plain tile raster's frame.
* ``vary`` writes one PNG per seed, and a meta graph's variants differ.
"""

import contextlib
import importlib.util
import io
import json
import pathlib

import numpy as np
import pytest
from test_torch_chunked_engine import few_torch_threads  # noqa: F401  (an autouse fixture)

from impact_tpu_torch.apps import voxel_generator as tgen
from impact_tpu_torch.utils.image import load_png, rgb_hybrid_compare
from impact_tpu_torch.voxel import meta_sdf as tmeta

PARITY_BAR = 0.95


@pytest.fixture(scope="module")
def jgen():
    path = pathlib.Path(__file__).resolve().parents[1] / "apps" / "voxel_generator.py"
    spec = importlib.util.spec_from_file_location("reference_voxel_generator", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def graph_files(tmp_path_factory, jgen):
    d = tmp_path_factory.mktemp("graphs")
    tgen.cmd_example(str(d / "example.json"))
    jgen.cmd_example(str(d / "example_ref.json"))
    meta = tmeta.sphere_surface_transforms(tmeta.meta_boxes(extent=tmeta.uniform(0.4, 1.2)),
                                           count=12, sphere_radius=5.0, jitter=0.2)
    (d / "meta.json").write_text(json.dumps(meta))
    return d


def printed(fn, *args, **kwargs):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args, **kwargs)
    return out.getvalue().strip()


def test_example_files_are_interchangeable(graph_files, jgen):
    port = json.loads((graph_files / "example.json").read_text())
    assert port == json.loads((graph_files / "example_ref.json").read_text())
    assert tgen.load_any_graph(graph_files / "example_ref.json") == jgen._load_any_graph(
        graph_files / "example.json")


@pytest.mark.parametrize("graph", ["example.json", "meta.json"])
def test_stats_print_the_reference_counts(graph, graph_files, jgen):
    path = str(graph_files / graph)
    got = printed(tgen.cmd_stats, path, device="cpu")
    assert got == printed(jgen.cmd_stats, path)
    s = tgen.stats(tgen.load_any_graph(path), "cpu")
    assert s["line"] == got and s["solid"] > 0 and s["triangles"] > 0


def test_preview_scores_against_the_reference(graph_files, jgen, tmp_path):
    path = str(graph_files / "example.json")
    tgen.cmd_preview(path, str(tmp_path / "port.png"), device="cpu")
    jgen.cmd_preview(path, str(tmp_path / "ref.png"))
    got, ref = load_png(tmp_path / "port.png"), load_png(tmp_path / "ref.png")
    assert got.shape == ref.shape == (tgen.HEIGHT, tgen.WIDTH, 3)
    score = rgb_hybrid_compare(got, ref)
    plain = tgen.preview_frame(tgen.load_any_graph(path), "cpu", raster_backend="raster")
    vs_plain = rgb_hybrid_compare(got, plain.numpy())
    print(f"preview: {score:.4f} against the reference app's, {vs_plain:.4f} against the "
          f"plain tile raster's")
    assert score >= PARITY_BAR and vs_plain >= PARITY_BAR
    assert got.astype(np.float32).std() > 1.0


def test_vary_writes_distinct_meta_variants(graph_files, tmp_path):
    tgen.main(["--device", "cpu", "vary", str(graph_files / "meta.json"), str(tmp_path), "2"])
    a, b = (load_png(tmp_path / f"variant_{s}.png") for s in (0, 1))
    assert a.shape == (tgen.HEIGHT, tgen.WIDTH, 3) and not np.array_equal(a, b)
