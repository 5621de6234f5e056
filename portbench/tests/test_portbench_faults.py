"""``correct`` comes out false when the timed path is broken underneath, and when the control, the
reference one precision down, stands in the program's place. The runs skip the harness's look for a
card and drive the rest of a run on the CPU at a tiny size."""
import time

import pytest
import torch

import metrics_tpu_torch
from portbench import harness
from portbench.tests.tiny import CELLS, CLASSES, make_root


def _run(root, cell):
    return harness.run(root, cell, 2**31 + 21, 0.1, False, torch.device("cpu"), time.time(), log=lambda m: None)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(tmp_path, cell):
    result = _run(make_root(tmp_path), cell)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "checks"
    assert result["checks"]["confmat_max_abs_diff"] == {"value": 0.0, "limit": 0}


def _unchanged(update):
    """An update that runs and then leaves every member's state as it found it."""

    def broken(self, *args, **kwargs):
        before = {name: {key: getattr(m, key).clone() for key in m._defaults} for name, m in self.items(keep_base=True)}
        update(self, *args, **kwargs)
        for name, leaves in before.items():
            for key, value in leaves.items():
                object.__setattr__(self[name], key, value)

    return broken


def _half_batch(update):
    def broken(self, preds, target):
        half = max(1, preds.shape[0] // 2)
        return update(self, preds[:half], target[:half])

    return broken


def _altered_answer(compute):
    def broken(self):
        values = compute(self)
        return {k: (v + 1e-3 if k == "JaccardIndex" else v) for k, v in values.items()}

    return broken


def _altered_pixel(update):
    def broken(self, preds, target):
        target = target.clone()
        target.view(-1)[0] = (target.view(-1)[0] + 1) % CLASSES
        return update(self, preds, target)

    return broken


FAULTS = {
    "state unchanged": lambda: ("update", _unchanged(metrics_tpu_torch.MetricCollection.update)),
    "half the batch": lambda: ("update", _half_batch(metrics_tpu_torch.MetricCollection.update)),
    "an answer altered": lambda: ("compute", _altered_answer(metrics_tpu_torch.MetricCollection.compute)),
    "a pixel altered": lambda: ("update", _altered_pixel(metrics_tpu_torch.MetricCollection.update)),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, cell, fault):
    name, broken = FAULTS[fault]()
    monkeypatch.setattr(metrics_tpu_torch.MetricCollection, name, broken)
    result = _run(make_root(tmp_path), cell)
    assert not result["correct"] and result["failed"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_in_the_program_place_is_not_correct(tmp_path, cell):
    root = make_root(tmp_path, classes=20, images=8, height=256, width=256)
    target = harness.cells(root)[cell]
    task = harness.task_class(target.config)(target.config, target.mix, 2**31 + 5, torch.device("cpu"))
    task.build()
    task.warm()
    for _ in range(2):
        task.epoch()
    task.free_program()
    assert harness.check(target, task)["correct"]
    verdict = harness.check(target, task, control=True)
    assert not verdict["correct"] and verdict["failed"] == verdict["attempted"]
