"""The ``fid_inception`` cell's task at a size the CPU runs in seconds (64 x 64 images resized to 96,
six a side, batches of 4 and 2): ``correct`` comes out false when the timed path is broken underneath
and when the control stands in the program's place; the cell's new readers give nothing on a trace
without the program's marks or counters, as a checkout from before them would give.

    python -m pytest --noconftest portbench/tests/test_portbench_fid.py          # the CPU tests
    python -m pytest --noconftest portbench/tests/test_portbench_fid.py -m cuda  # and the card's
"""
import json
import time
from pathlib import Path

import pytest
import torch

import metrics_tpu_torch
from metrics_tpu_torch import telemetry
from metrics_tpu_torch.metric import Metric
from portbench import harness
from portbench.tests.tiny import REPO
from portbench.trace import Reading

CELL = "tiny_fid.fid10k"
READERS = ("fid_mfu_pct", "extract_roofline_pct", "extract_resized_pct")  # the cell's own


def make_fid_root(root: Path) -> Path:
    """A throwaway checkout holding the cell at the tiny size, under the real cell's limits."""
    for sub in ("configs", "mixes", "limits"):
        (root / "portbench" / sub).mkdir(parents=True, exist_ok=True)
    config = json.loads((REPO / "portbench/configs/fid_inception.json").read_text())
    config.update(images=6, real_images=6, height=64, width=64, extractor={"resize": 96})
    (root / "portbench/configs/tiny_fid.json").write_text(json.dumps(config))
    mix = json.loads((REPO / "portbench/mixes/fid10k.json").read_text())
    mix["batch"] = 4
    (root / "portbench/mixes/fid10k.json").write_text(json.dumps(mix))
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    manifest["configs"] = [{"name": "tiny_fid", "source": "https://example.org/tiny", "reduced": [],
                            "file": "portbench/configs/tiny_fid.json", "why": "a test size"}]
    manifest["workloads"] = [{"name": CELL, "config": "tiny_fid", "traffic": "fid10k", "chips": 1, "why": "a test"}]
    manifest["per_layer"] = [dict(m, workloads=[CELL]) for m in manifest["per_layer"]
                             if "fid_inception.fid10k" in m.get("workloads", [])]
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    limits = (REPO / "portbench/limits/fid_inception.fid10k.json").read_text()
    (root / f"portbench/limits/{CELL}.json").write_text(limits)
    return root


def _run(root, device=torch.device("cpu"), trace=False):
    return harness.run(root, CELL, 2**31 + 27, 0.1, trace, device, time.time(), log=lambda m: None)


def test_a_sound_run_is_correct(tmp_path):
    result = _run(make_fid_root(tmp_path))
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1, result["checks"]
    assert set(result["checks"]) == {"mu_max_rel_gap", "fid_rel_gap", "n_fake_gap"}
    assert result["checks"]["n_fake_gap"]["value"] == 0.0


_update = metrics_tpu_torch.FrechetInceptionDistance.update


def _image_left_out(self, imgs, real):
    return _update(self, imgs if real else imgs[:-1], real)


def _image_altered(self, imgs, real):
    if not real:
        imgs = imgs.clone()
        imgs[0] = 255 - imgs[0]
    return _update(self, imgs, real)


def _real_side_reset(self):
    """A reset that keeps the real side's count and loses its sums."""
    kept = self.real_num_samples
    Metric.reset(self)
    self.real_num_samples = kept


FAULTS = {
    "a generated image left out": ("update", _image_left_out),
    "a generated image altered": ("update", _image_altered),
    "the real side reset": ("reset", _real_side_reset),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault):
    name, broken = FAULTS[fault]
    monkeypatch.setattr(metrics_tpu_torch.FrechetInceptionDistance, name, broken)
    result = _run(make_fid_root(tmp_path))
    assert not result["correct"] and result["failed"] == result["attempted"] >= 1, result["checks"]


def _task_after_two_epochs(root, device):
    cell = harness.cells(root)[CELL]
    task = harness.task_class(cell.config)(cell.config, cell.mix, 2**31 + 5, device)
    task.build()
    task.warm()
    for _ in range(2):
        task.epoch()
    task.free_program()
    return cell, task


def test_the_bfloat16_control_in_the_program_place_is_not_correct(tmp_path):
    cell, task = _task_after_two_epochs(make_fid_root(tmp_path), torch.device("cpu"))
    assert harness.check(cell, task)["correct"]
    verdict = harness.check(cell, task, control="bfloat16")
    assert not verdict["correct"] and verdict["failed"] == verdict["attempted"] == 2


@pytest.mark.cuda
def test_the_tf32_control_in_the_program_place_is_not_correct_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    cell, task = _task_after_two_epochs(make_fid_root(tmp_path), torch.device("cuda", 0))
    assert harness.check(cell, task)["correct"]
    for control in (True, "bfloat16"):  # True: the cell's control, TF32
        verdict = harness.check(cell, task, control=control)
        assert not verdict["correct"] and verdict["failed"] == verdict["attempted"] == 2, (control, verdict)


def _reading(ops=(), compute_ms=(), work=({"images": 64, "size": 299},)):
    reading = Reading(compute_ms=list(compute_ms), work=list(work))
    reading.ops, reading.window, reading.epochs = list(ops), (0.0, 1e5), 1
    return reading


def test_the_new_readers_give_nothing_where_the_program_leaves_nothing():
    telemetry.reset_counters()
    empty = Reading(compute_ms=[], work=[])
    assert all(harness.layer_reader(name)(empty) is None for name in READERS)
    unmarked = _reading(ops=[("void cudnn::conv_kernel(...)", 0.0, 5e4)])
    assert harness.layer_reader("extract_roofline_pct")(unmarked) is None
    assert harness.layer_reader("extract_resized_pct")(unmarked) is None


def test_the_marked_trunk_and_the_window_give_the_shares_of_the_peak():
    # one update of 64 images: the trunk from the extract mark's end (10 us) to the count mark (40,010 us)
    ops = [("void (anonymous namespace)::phase_mark_format()", 0.0, 2.0),
           ("void (anonymous namespace)::phase_mark_extract()", 8.0, 10.0),
           ("void cudnn::conv_kernel(...)", 12.0, 40000.0),
           ("void (anonymous namespace)::phase_mark_count()", 40010.0, 40012.0)]
    reading = _reading(ops=ops, compute_ms=[200.0, 300.0])
    least_us = 2 * 5711168096 * 64 / 67e12 * 1e6
    assert harness.layer_reader("extract_roofline_pct")(reading) == pytest.approx(100 * least_us / 40000.0)
    assert harness.layer_reader("fid_mfu_pct")(reading) == pytest.approx(100 * least_us / 1e5)
    assert harness.layer_reader("compute_ms")(reading) == 250.0
