"""The harness finds every configuration, traffic mix, driver, limit set
and metric by name, and takes up an added file without an edit."""

import json
import shutil

from slam_bench import registry


def test_every_name_in_the_benchmark_resolves(bench):
    for w in bench["workloads"]:
        cell = registry.load_cell(w["name"], bench)
        assert registry.module("drivers", cell.traffic["driver"]).sequence
        assert cell.end_to_end and cell.per_layer
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(registry.module("metrics", m["name"]).read)
    for c in bench["configs"]:
        assert registry.data("configs", c["name"]) is not None
        assert c["file"] == f"slam_bench/configs/{c['name']}.json"


def test_every_file_loads():
    """A file no cell names yet (kept for a cell a later change adds) still
    loads: its data parses, its module has the entry the harness calls."""
    for kind, entry in (("drivers", "sequence"), ("metrics", "read")):
        for name in registry.names(kind):
            assert callable(getattr(registry.module(kind, name), entry)), name
    for kind in ("configs", "traffic", "limits"):
        for name in registry.names(kind):
            assert isinstance(registry.data(kind, name), dict), name


def test_an_added_file_is_taken_up_without_an_edit(tmp_path, bench):
    root = tmp_path / "slam_bench"
    for kind in registry.KINDS:
        shutil.copytree(registry.HERE / kind, root / kind)
    (root / "metrics" / "frames_per_sequence.py").write_text(
        "def read(run):\n    return run.seqs[0].frames\n")
    (root / "traffic" / "vo-short.json").write_text(json.dumps(
        dict(registry.data("traffic", "vo-replay"), world=dict(
            registry.data("traffic", "vo-replay")["world"], n_frames=12))))
    (root / "limits" / "euroc-vo-short.json").write_text(json.dumps(
        registry.data("limits", "euroc-vo-replay")))
    added = dict(bench, workloads=bench["workloads"] + [
        {"name": "euroc-vo-short", "config": "euroc-stereo", "traffic": "vo-short",
         "chips": 1, "why": "a test"}],
        per_layer=bench["per_layer"] + [
            {"name": "frames_per_sequence", "unit": "frames", "better": "higher",
             "source": "host_clock", "layer": "test", "moves": "vo_fps",
             "workloads": ["euroc-vo-short"]}])
    assert "frames_per_sequence" in registry.names("metrics", root)
    assert "vo-short" in registry.names("traffic", root)
    cell = registry.load_cell("euroc-vo-short", added, root)
    assert cell.traffic["world"]["n_frames"] == 12
    assert [m["name"] for m in cell.per_layer if m["name"] == "frames_per_sequence"]
    reader = registry.module("metrics", "frames_per_sequence", root)

    class Run:
        seqs = [type("S", (), {"frames": 12})()]
    assert reader.read(Run()) == 12
