"""BENCHMARK.json against the benchmark's contract, and the harness finding every cell's files by name."""
import json
import re
import shutil

import pytest

from portbench import harness
from portbench.tests.tiny import REPO, make_root

MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", *KEYS}
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(MANIFEST["command"]) <= 32 and all(_line(w) for w in MANIFEST["command"])
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for path in MANIFEST["paths"]:
        assert PATH.match(path) and not path.startswith("/") and ".." not in path.split("/")
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51
    counts = {"configs": (1, 24), "workloads": (1, 24), "end_to_end": (1, 16), "per_layer": (1, 128)}
    for section, (low, high) in counts.items():
        assert low <= len(MANIFEST[section]) <= high


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_keys_names_and_units(section):
    entries = MANIFEST[section]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for entry in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(entry) <= KEYS[section] | extra, entry["name"]
        assert NAME.match(entry["name"]), entry["name"]
        if "unit" in entry:
            assert UNIT.match(entry["unit"]), entry["unit"]
            assert entry["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in entry and section != "end_to_end":
                assert _line(entry[key]), (entry["name"], key)


def test_configs_files_and_reduced():
    paths = MANIFEST["paths"]
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(set(files)) == len(files)
    for config in MANIFEST["configs"]:
        assert any(config["file"].startswith(p + "/") for p in paths)
        assert (REPO / config["file"]).is_file()
        assert config["source"].startswith("https://")
        assert len(config["reduced"]) <= 16 and all(NAME.match(k) for k in config["reduced"])
        assert json.loads((REPO / config["file"]).read_text())["reduced"] == config["reduced"]


def test_every_configuration_keeps_a_cell_and_cells_are_distinct():
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in MANIFEST["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4)
    fours = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert fours <= max(1, len(MANIFEST["workloads"]) // 4)


def test_bounds_and_sources():
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m["name"]
        assert m["source"] in ("host_clock", "device_trace")
    for m in MANIFEST["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert any(m["name"] == "setup_s" for m in MANIFEST["end_to_end"])


def _reports(metric, cell):
    return cell in metric.get("workloads", [cell])


def test_every_per_layer_metric_moves_an_end_to_end_metric_its_cells_report():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    cells = [w["name"] for w in MANIFEST["workloads"]]
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        for cell in m.get("workloads", cells):
            assert cell in cells and _reports(e2e[m["moves"]], cell), (m["name"], cell)
    layers = {}
    for m in MANIFEST["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
    assert all(_line(layer) for layer in layers)


def test_every_cell_reports_setup_another_end_to_end_metric_and_a_per_layer_metric():
    for w in MANIFEST["workloads"]:
        e2e = [m["name"] for m in MANIFEST["end_to_end"] if _reports(m, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(_reports(m, w["name"]) for m in MANIFEST["per_layer"])


def test_roofline_and_mfu_names():
    for m in MANIFEST["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%" and m["better"] == "higher"


def test_the_harness_finds_each_cell_its_files_and_readers():
    found = harness.cells(REPO)
    assert set(found) == {w["name"] for w in MANIFEST["workloads"]}
    for cell in found.values():
        assert cell.limits is not None, cell.name
        assert harness.task_class(cell.config) is not None
        for m in cell.metrics("per_layer"):
            assert callable(harness.layer_reader(m["name"]))
        assert {m["name"] for m in cell.metrics("end_to_end")} == {"images_per_s", "metric_peak_mib", "setup_s"}


def test_a_new_configuration_and_mix_make_a_cell_without_any_edit(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(REPO / "portbench" / "configs", root / "portbench" / "configs")
    shutil.copytree(REPO / "portbench" / "mixes", root / "portbench" / "mixes")
    manifest = json.loads(json.dumps(MANIFEST))
    config = json.loads((REPO / "portbench/configs/ade20k_val_seg.json").read_text())
    config["images"] = 1000
    (root / "portbench/configs/throwaway.json").write_text(json.dumps(config))
    mix = json.loads((REPO / "portbench/mixes/eval_labels.json").read_text())
    mix["updates_per_epoch"] = 50
    (root / "portbench/mixes/throwaway_mix.json").write_text(json.dumps(mix))
    manifest["configs"].append({"name": "throwaway", "source": "https://example.org", "file": "portbench/configs/throwaway.json",
                                "reduced": [], "why": "a test"})
    manifest["workloads"].append({"name": "throwaway.mix", "config": "throwaway", "traffic": "throwaway_mix", "chips": 1,
                                  "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    found = harness.cells(root)
    assert "throwaway.mix" in found
    assert found["throwaway.mix"].config["images"] == 1000 and found["throwaway.mix"].mix["updates_per_epoch"] == 50


def test_tiny_checkout_is_a_valid_root(tmp_path):
    assert set(harness.cells(make_root(tmp_path))) == {"tiny.logits", "tiny.labels"}
