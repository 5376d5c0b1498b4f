"""The harness finds every cell, configuration, traffic mix, metric and limit
by its name, and BENCHMARK.json keeps to the benchmark's contract."""
import dataclasses
import json
import re
import shutil

import pytest

from rtbench import harness

BENCH = harness.load_bench()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "rtbench/run.py"]
    assert BENCH["paths"] == ["rtbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_entries_keep_to_the_contract():
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("rtbench/") and (harness.ROOT / c["file"]).is_file()
        assert c["source"].startswith("https://") and len(c["source"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.fullmatch(e["name"]) and e["name"] not in names
            names.add(e["name"])
            if "unit" in e:
                assert UNIT.fullmatch(e["unit"]) and e["better"] in ("lower", "higher")
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}


@pytest.mark.parametrize("name", WORKLOADS)
def test_every_workload_loads_by_name(name):
    cell = harness.load_cell(name)
    assert "setup_s" in cell.end_to_end and len(cell.end_to_end) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    assert callable(harness.find_loop(cell).run)
    assert set(cell.limits) >= {"overflow"} and cell.limits["overflow"] == 0
    for mod in cell.per_layer.values():
        assert callable(mod.read)
    for m in BENCH["per_layer"]:
        if name in m.get("workloads", []):
            assert m["moves"] in cell.end_to_end


def test_new_files_are_found_without_an_edit(tmp_path):
    """A later change adds a cell, a traffic mix, a metric and a limit as
    files and entries; the harness finds them by name."""
    shutil.copytree(harness.ROOT / "rtbench", tmp_path / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append(dict(bench["configs"][1], name="bunny256",
                                 file="rtbench/configs/bunny256.json"))
    bench["workloads"].append({"name": "bunny256.spin", "config": "bunny256", "traffic": "spin",
                               "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({"name": "unit_ms.frame", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "harness",
                               "moves": "frame_ms", "workloads": ["bunny256.spin"]})
    bench["end_to_end"][0]["workloads"].append("bunny256.spin")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cfg = json.loads((harness.ROOT / "rtbench/configs/bunny512.json").read_text())
    cfg["render"]["height"] = cfg["render"]["width"] = 256
    (tmp_path / "rtbench/configs/bunny256.json").write_text(json.dumps(cfg))
    (tmp_path / "rtbench/traffic/spin.json").write_text(json.dumps(
        {"loop": "frames", "camera": {"path": "orbit", "period": 30}}))
    (tmp_path / "rtbench/metrics/unit_ms.frame.py").write_text(
        "SPANS = {}\n\ndef read(t):\n    return t.per_unit_ms('unit')\n")
    (tmp_path / "rtbench/limits/bunny256.spin.json").write_text(
        json.dumps({"bad_pixel_share": 0.001, "overflow": 0}))
    cell = harness.load_cell("bunny256.spin", root=tmp_path)
    assert cell.config["render"]["height"] == 256
    assert cell.traffic["camera"]["period"] == 30
    assert harness.find_loop(cell).__file__ == str(tmp_path / "rtbench/loops/frames.py")
    assert list(cell.per_layer) == ["unit_ms.frame"]
    assert cell.end_to_end == ["frame_ms", "setup_s"]
    assert harness.load_cell("bunny512.orbit", root=tmp_path).per_layer.keys() == \
        harness.load_cell("bunny512.orbit").per_layer.keys()


def test_metric_files_match_the_entries():
    files = {p.name[:-3] for p in (harness.HERE / "metrics").glob("*.py")}
    assert files == {m["name"] for m in BENCH["per_layer"]}
    for m in BENCH["per_layer"]:
        mod = harness.load_metric(m["name"])
        for target in getattr(mod, "SPANS", {}).values():
            assert re.fullmatch(r"tracer_torch(\.\w+)+:\w+", target)


def test_span_targets_exist_in_the_program():
    """Every wrapped name is there today; a rename fails the traced run."""
    import importlib

    for m in BENCH["per_layer"]:
        for target in getattr(harness.load_metric(m["name"]), "SPANS", {}).values():
            mod, attr = target.split(":")
            assert hasattr(importlib.import_module(mod), attr), target


def test_a_missing_span_target_raises():
    import torch

    from rtbench import spans

    tr = spans.Tracer(torch.device("cpu"))
    with pytest.raises(AttributeError, match="new name"):
        tr.install("x", "tracer_torch.api:no_such_function")


def test_a_new_loop_and_camera_path_are_found_without_an_edit(tmp_path):
    """A later change adds a loop and a camera path as files; a mix names
    them and the harness runs them."""
    shutil.copytree(harness.ROOT / "rtbench", tmp_path / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    (tmp_path / "rtbench/cameras/still2.py").write_text(
        "def cameras(spec, preset):\n    return [dict(preset), dict(preset)]\n")
    (tmp_path / "rtbench/loops/count.py").write_text(
        "from rtbench import generate\n\n"
        "def run(cell, seed, seconds, trace, device, t_process):\n"
        "    path = generate.camera_path(cell.traffic['camera'], {'fov_y_deg': 1}, cell.root)\n"
        "    return {'correct': True, 'attempted': len(path)}\n")
    cell = harness.load_cell("bunny512.orbit", root=tmp_path)
    cell.traffic = {"loop": "count", "camera": {"path": "still2"}}
    res = harness.run_cell(cell, 1, 0.0, False, "cpu", 0.0)
    assert res == {"correct": True, "attempted": 2}
    with pytest.raises(FileNotFoundError, match="no loops 'nowhere'"):
        harness.find_loop(dataclasses.replace(cell, traffic={"loop": "nowhere"}))
