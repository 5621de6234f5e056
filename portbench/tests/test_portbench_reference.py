"""The plain reference against hand-computed cases, the program against it on the CPU, the work
functions' bytes, and the traffic's guarantees."""
import json

import pytest
import torch

from portbench import harness
from portbench.references import segmentation as reference
from portbench.tests.tiny import REPO
from portbench.traffic import segmentation as traffic




def test_confusion_matrix_and_scores_by_hand():
    # 3 classes, the void is class 2; rows by target, columns by prediction
    target = torch.tensor([[[0, 0, 1, 1, 2, 2]]])
    pred = torch.tensor([[[0, 1, 1, 1, 0, 1]]])
    cm = reference.image_confmats(target, pred, 3)[0]
    assert cm.tolist() == [[1, 1, 0], [0, 2, 0], [1, 1, 0]]
    miou, aacc = reference.miou_aacc(cm, void=2)
    # void row cleared: class 0 IoU 1 / (1 + 2 - 1) = 1/2, class 1 IoU 2 / (3 + 2 - 2) = 2/3
    assert miou == pytest.approx((1 / 2 + 2 / 3) / 2, abs=1e-15)
    # the pixels whose target is not the void: 3 right of 4
    assert aacc == pytest.approx(3 / 4, abs=1e-15)


def test_absent_class_scores_zero_and_first_largest_channel_wins():
    cm = torch.tensor([[5, 0, 0], [0, 0, 0], [0, 0, 0]])
    miou, _ = reference.miou_aacc(cm, void=2)
    assert miou == pytest.approx(0.5)
    scores = torch.tensor([[[[1.0]], [[3.0]], [[3.0]]]])
    assert reference.predicted(scores).item() == 1


def test_accumulation_in_float32_loses_counts_past_two_to_the_24():
    parts = [torch.tensor([[2**24]]), torch.tensor([[1]])]
    assert reference.accumulate(parts).item() == 2**24 + 1
    assert reference.accumulate(parts, reference.CONTROL_COUNTS).item() == 2**24


@pytest.mark.parametrize("mix", ["eval_logits", "eval_labels"])
def test_the_program_on_the_cpu_matches_the_reference(mix):
    import metrics_tpu_torch as program

    config = json.loads((REPO / "portbench/configs/cityscapes_val_seg.json").read_text())
    config.update(images=6, height=64, width=64)
    mixes = json.loads((REPO / f"portbench/mixes/{mix}.json").read_text())
    mixes["updates_per_epoch"] = 2
    geo = traffic.Geometry(config, mixes)
    pool = traffic.make_pool(config, mixes, geo, seed=5, device=torch.device("cpu"))
    coll = program.MetricCollection([program.JaccardIndex(device="cpu", **config["metrics"]["JaccardIndex"]),
                                     program.Accuracy(device="cpu", **config["metrics"]["Accuracy"])])
    parts = []
    for g, n in enumerate(geo.sizes):
        preds, target = traffic.update_batch(pool, geo, g, n)
        coll.update(preds, target)
        pred = reference.predicted(preds) if mix == "eval_logits" else preds
        parts.append(reference.image_confmats(target, pred, 20).sum(0))
    cm = reference.accumulate(parts)
    values = coll.compute()
    assert torch.equal(coll["JaccardIndex"].confmat.long(), cm)
    miou, aacc = reference.miou_aacc(cm, void=19)
    assert float(values["JaccardIndex"]) == pytest.approx(miou, abs=1e-6)
    assert float(values["Accuracy"]) == pytest.approx(aacc, abs=1e-6)


def test_traffic_is_seeded_tie_free_and_never_predicts_the_void():
    config = json.loads((REPO / "portbench/configs/ade20k_val_seg.json").read_text())
    config.update(images=4, height=64, width=64)
    mix = json.loads((REPO / "portbench/mixes/eval_logits.json").read_text())
    mix["updates_per_epoch"] = 2
    geo = traffic.Geometry(config, mix)
    a = traffic.make_pool(config, mix, geo, seed=2**31 + 11, device=torch.device("cpu"))
    b = traffic.make_pool(config, mix, geo, seed=2**31 + 11, device=torch.device("cpu"))
    assert all(torch.equal(x[0], y[0]) and torch.equal(x[1], y[1]) for x, y in zip(a, b))
    scores, target = a[0]
    top2 = scores.topk(2, dim=1).values
    assert bool((top2[:, 0] > top2[:, 1]).all())
    assert bool((scores.argmax(1) != config["void"]).all())
    assert int(target.max()) == config["void"] and int(target.min()) >= 0


@pytest.mark.parametrize("config,mix,batch_bytes,pool", [
    ("cityscapes_val_seg", "eval_logits", 738_197_504, 8),
    ("ade20k_val_seg", "eval_logits", 2_566_914_048, 4),
    ("cityscapes_val_seg", "eval_labels", 268_435_456, 8),
])
def test_the_work_functions_give_the_stated_bytes(config, mix, batch_bytes, pool):
    geo = traffic.Geometry(json.loads((REPO / f"portbench/configs/{config}.json").read_text()),
                           json.loads((REPO / f"portbench/mixes/{mix}.json").read_text()))
    assert geo.batch_bytes(geo.batch) == batch_bytes and geo.pool == pool
    confmat = harness.layer_reader("confmat_roofline_pct").__globals__["confmat_bytes"]
    rows = geo.batch * geo.pixels
    assert confmat(rows, geo.num_classes) == 2 * rows + 4 * geo.num_classes**2
    update = harness.layer_reader("update_roofline_pct").__globals__["update_bytes"]
    assert update({"input_bytes": batch_bytes}) == batch_bytes
