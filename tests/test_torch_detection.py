"""The port's MeanAveragePrecision and box helpers held against the JAX package on the CPU.

The same seeded numpy detections go through ``metrics_tpu.detection`` and
``metrics_tpu_torch.detection``. Everything is exact: the box helpers'
float32 results, the per-image list states, every output with its dtype
(float32 values, int32 classes), the core's matches against the numpy
greedy loop (the plain version of ``native.coco_match``, kept here), a
two-rank sync against one process. The pycocotools-verified fixture of
``tests/detection/test_map_golden.py`` gives its recorded values within that
file's 1e-3.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu.detection import MeanAveragePrecision as JaxMAP
from metrics_tpu.detection import helpers as jax_helpers
from metrics_tpu_torch import native
from metrics_tpu_torch.detection import MeanAveragePrecision, box_area, box_convert, box_iou
from metrics_tpu_torch.interop import load_jax_state_dict, to_jax_state_dict
from tests.detection.test_map_golden import _GOLDEN_ATOL, EXPECTED, _preds, _target
from tests.test_torch_image_paths import JaxPair, TorchPair, run_ranks

FORMATS = ("xyxy", "xywh", "cxcywh")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bits(t, j):
    got, want = _np(t), np.asarray(j)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


def _same_result(got, want):
    assert list(got) == list(want)
    for key in want:
        _bits(got[key], want[key])


def _torch(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _jax(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _coco_images(seed, n, box_format="xyxy", classes=80, max_det=100):
    """COCO-shaped images (640 x 480): ~7 ground-truth boxes of a few classes,
    up to ``max_det`` detections from a noisy detector (jittered copies of
    the boxes and random boxes, some of the right class); every fifth image
    has no detections, every seventh no ground truth. Boxes in ``box_format``."""
    rng = np.random.RandomState(seed)
    preds, targets = [], []
    for i in range(n):
        n_gt = 0 if i % 7 == 6 else rng.poisson(7)
        wh = np.exp(rng.uniform(np.log(8), np.log(400), (n_gt, 2)))
        xy = rng.uniform(0, 1, (n_gt, 2)) * (np.array([640, 480]) - wh).clip(1)
        gt = np.concatenate([xy, xy + wh], 1).astype(np.float32)
        gt_labels = rng.randint(0, classes, n_gt)
        n_det = 0 if i % 5 == 4 else rng.randint(1, max_det + 1)
        src = rng.randint(0, max(n_gt, 1), n_det)
        jitter = rng.normal(0, 0.1, (n_det, 4)) * np.tile(wh[src] if n_gt else np.full((n_det, 2), 50.0), 2)
        det = (gt[src] if n_gt else np.tile([100, 100, 200, 200], (n_det, 1))) + jitter
        rand = rng.rand(n_det) < 0.4
        rwh = rng.uniform(4, 300, (n_det, 2))
        rxy = rng.uniform(0, 600, (n_det, 2))
        det[rand] = np.concatenate([rxy, rxy + rwh], 1)[rand]
        det = np.concatenate([det[:, :2], np.maximum(det[:, 2:], det[:, :2] + 1)], 1).astype(np.float32)
        det_labels = np.where(rng.rand(n_det) < 0.7, gt_labels[src] if n_gt else 0, rng.randint(0, classes, n_det))
        scores = rng.rand(n_det).astype(np.float32)
        scores[: n_det // 10] = 0.5  # ties in score order
        preds.append({"boxes": _from_xyxy(det, box_format), "scores": scores, "labels": det_labels.astype(np.int64)})
        targets.append({"boxes": _from_xyxy(gt, box_format), "labels": gt_labels.astype(np.int64)})
    return preds, targets


def _from_xyxy(b, fmt):
    if fmt == "xyxy":
        return b.reshape(-1, 4)
    x1, y1, x2, y2 = b.reshape(-1, 4).T
    if fmt == "xywh":
        return np.stack([x1, y1, x2 - x1, y2 - y1], 1).astype(np.float32)
    return np.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], 1).astype(np.float32)


def _both(preds, targets, batch=4, **kwargs):
    jm, tm = JaxMAP(**kwargs), MeanAveragePrecision(device="cpu", **kwargs)
    for i in range(0, len(preds), batch):
        jm.update([_jax(p) for p in preds[i:i + batch]], [_jax(t) for t in targets[i:i + batch]])
        tm.update([_torch(p) for p in preds[i:i + batch]], [_torch(t) for t in targets[i:i + batch]])
    return jm, tm


def _same_state(tm, jm):
    for key in tm._defaults:
        got, want = getattr(tm, key), getattr(jm, key)
        assert len(got) == len(want), key
        for g, w in zip(got, want):
            _bits(g, w)


# ------------------------------------------------------------------- helpers
@pytest.mark.parametrize("in_fmt", FORMATS)
@pytest.mark.parametrize("out_fmt", FORMATS)
def test_box_helpers_are_jax(in_fmt, out_fmt):
    rng = np.random.RandomState(0)
    boxes = rng.uniform(0, 500, (50, 4)).astype(np.float32)
    boxes[:, 2:] = boxes[:, :2] + rng.uniform(0, 100, (50, 2)).astype(np.float32)
    _bits(box_convert(torch.from_numpy(boxes), in_fmt, out_fmt), jax_helpers.box_convert(jnp.asarray(boxes), in_fmt, out_fmt))
    _bits(box_area(torch.from_numpy(boxes)), jax_helpers.box_area(jnp.asarray(boxes)))
    other = boxes[::-1].copy()
    other[:5] = other[:5, [0, 1, 0, 1]]  # zero-area boxes: union 0 where both are empty
    _bits(box_iou(torch.from_numpy(boxes), torch.from_numpy(other)),
          jax_helpers.box_iou(jnp.asarray(boxes), jnp.asarray(other)))
    with pytest.raises(ValueError) as jax_err:
        jax_helpers.box_convert(jnp.asarray(boxes), in_fmt, "xy")
    with pytest.raises(ValueError) as port_err:
        box_convert(torch.from_numpy(boxes), in_fmt, "xy")
    assert str(port_err.value) == str(jax_err.value)


# ------------------------------------------------------------------ the core
def _numpy_coco_match(ious, gt_ignore, thresholds):
    """The greedy matching loop of the JAX package's numpy path: detections in
    score order claim the best free ground truth at or above the threshold,
    an ignored one only when no valid one qualifies."""
    n_det, n_gt = ious.shape
    det_matched = np.zeros((len(thresholds), n_det), dtype=bool)
    det_matched_ignored = np.zeros((len(thresholds), n_det), dtype=bool)
    gt_matched = np.zeros((len(thresholds), n_gt), dtype=bool)
    for t, thr in enumerate(thresholds):
        for d in range(n_det):
            best_iou = min(thr, 1 - 1e-10)
            best_g = -1
            for g in range(n_gt):
                if gt_matched[t, g]:
                    continue
                if best_g > -1 and not gt_ignore[best_g] and gt_ignore[g]:
                    break
                if ious[d, g] >= best_iou:
                    best_iou = ious[d, g]
                    best_g = g
            if best_g > -1:
                det_matched[t, d] = True
                gt_matched[t, best_g] = True
                det_matched_ignored[t, d] = gt_ignore[best_g]
    return det_matched, det_matched_ignored


def test_coco_match_core_equals_the_numpy_loop():
    rng = np.random.RandomState(1)
    thresholds = np.linspace(0.5, 0.95, 10)
    for trial in range(300):
        n_det, n_gt = rng.randint(0, 30), rng.randint(0, 12)
        ious = rng.rand(n_det, n_gt) * (rng.rand(n_det, n_gt) < 0.5)
        ious[rng.rand(n_det, n_gt) < 0.1] = 0.75  # exact ties with a threshold
        gt_ignore = np.sort(rng.rand(n_gt) < 0.3)  # ignored ones last
        got = native.coco_match(ious, gt_ignore, thresholds)
        want = _numpy_coco_match(ious, gt_ignore, thresholds)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w, err_msg=str(trial))


def test_the_golden_fixture_gives_its_values_through_the_numpy_loop(monkeypatch):
    monkeypatch.setattr(native, "coco_match", _numpy_coco_match)
    tm = MeanAveragePrecision(class_metrics=True, device="cpu")
    for p, t in zip(_preds(), _target()):
        tm.update([_torch(x) for x in p], [_torch(x) for x in t])
    _assert_golden(tm.compute())


# ------------------------------------------------------------------- metric
def _assert_golden(result):
    for key, expected in EXPECTED.items():
        np.testing.assert_allclose(_np(result[key]).reshape(-1), np.asarray(expected, dtype=np.float64).reshape(-1),
                                   atol=_GOLDEN_ATOL, err_msg=key)


def test_golden_fixture_is_pycocotools_and_jax():
    jm, tm = JaxMAP(class_metrics=True), MeanAveragePrecision(class_metrics=True, device="cpu")
    for p, t in zip(_preds(), _target()):
        jm.update(p, t)
        tm.update([_torch(x) for x in p], [_torch(x) for x in t])
    _same_state(tm, jm)
    result = tm.compute()
    _assert_golden(result)
    _same_result(result, jm.compute())


@pytest.mark.parametrize("box_format", FORMATS)
def test_coco_shaped_images_are_jax_bit_for_bit(box_format):
    preds, targets = _coco_images(10 + FORMATS.index(box_format), 12, box_format)
    jm, tm = _both(preds, targets, box_format=box_format, class_metrics=True)
    _same_state(tm, jm)
    _same_result(tm.compute(), jm.compute())


@pytest.mark.parametrize("kwargs", [
    {},
    {"iou_thresholds": [0.5, 0.75], "rec_thresholds": [0.0, 0.5, 1.0], "max_detection_thresholds": [5, 50]},
    {"iou_thresholds": [0.3, 0.6], "class_metrics": True},
])
def test_protocol_options_are_jax(kwargs):
    preds, targets = _coco_images(20, 10, classes=6)
    jm, tm = _both(preds, targets, **kwargs)
    _same_result(tm.compute(), jm.compute())


def test_edge_cases_are_jax():
    """No update; only empty images; the duplicated-prediction regression of the golden file."""
    _same_result(MeanAveragePrecision(device="cpu").compute(), JaxMAP().compute())
    empty_p = {"boxes": np.zeros((0, 4), np.float32), "scores": np.zeros(0, np.float32), "labels": np.zeros(0, np.int64)}
    empty_t = {"boxes": np.zeros((0, 4), np.float32), "labels": np.zeros(0, np.int64)}
    jm, tm = _both([empty_p, empty_p], [empty_t, empty_t], class_metrics=True)
    _same_result(tm.compute(), jm.compute())
    box = np.asarray([[258.0, 41.0, 606.0, 285.0]], np.float32)
    p = {"boxes": box, "scores": np.asarray([0.536], np.float32), "labels": np.asarray([0])}
    jm, tm = _both([p, p], [{"boxes": np.asarray([[214.0, 41.0, 562.0, 285.0]], np.float32), "labels": np.asarray([0])},
                            empty_t])
    result = tm.compute()
    _same_result(result, jm.compute())
    assert float(result["map_50"]) == 1.0


def test_a_perfect_detector_scores_one():
    preds, targets = _coco_images(30, 20)
    perfect = [{"boxes": t["boxes"], "scores": np.linspace(1, 0.5, len(t["labels"]), dtype=np.float32),
                "labels": t["labels"]} for t in targets]
    result = _both(perfect, targets)[1].compute()
    assert float(result["map"]) == 1.0 and float(result["mar_100"]) == 1.0


def test_errors_are_jax():
    for kwargs in ({"box_format": "xy"}, {"class_metrics": 1}):
        with pytest.raises(ValueError) as jax_err:
            JaxMAP(**kwargs)
        with pytest.raises(ValueError) as port_err:
            MeanAveragePrecision(device="cpu", **kwargs)
        assert str(port_err.value) == str(jax_err.value)
    p = {"boxes": np.zeros((1, 4), np.float32), "scores": np.ones(1, np.float32), "labels": np.zeros(1, np.int64)}
    t = {"boxes": np.zeros((1, 4), np.float32), "labels": np.zeros(1, np.int64)}
    for preds, targets in (([p], [t, t]), ([{"boxes": p["boxes"], "labels": p["labels"]}], [t]),
                           ([p], [{"boxes": t["boxes"]}]), (p, [t])):
        with pytest.raises(ValueError) as jax_err:
            JaxMAP().update([_jax(x) for x in preds] if isinstance(preds, list) else preds,
                            [_jax(x) for x in targets])
        with pytest.raises(ValueError) as port_err:
            MeanAveragePrecision(device="cpu").update([_torch(x) for x in preds] if isinstance(preds, list) else preds,
                                                      [_torch(x) for x in targets])
        assert str(port_err.value) == str(jax_err.value)


def test_compute_reads_the_states_in_one_copy(monkeypatch):
    """Every image's arrays reach the host in one device-to-host copy."""
    preds, targets = _coco_images(40, 16)
    tm = _both(preds, targets)[1]
    reads = []
    real = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda self, *a, **k: reads.append(self.shape) or real(self, *a, **k))
    host = tm._host_states()
    assert len(reads) == 1
    for key, attr in (("det_boxes", "detection_boxes"), ("gt_labels", "groundtruth_labels")):
        assert len(host[key]) == 16
        for h, v in zip(host[key], getattr(tm, attr)):
            np.testing.assert_array_equal(h, v.numpy())


def test_checkpoints_cross_between_jax_and_port():
    preds, targets = _coco_images(50, 12)
    jm, tm = _both(preds[:6], targets[:6], class_metrics=True)
    back = JaxMAP(class_metrics=True)
    for m in (jm, tm, back):
        m.persistent(True)
    fresh = MeanAveragePrecision(class_metrics=True, device="cpu")
    fresh.persistent(True)
    load_jax_state_dict(fresh, jm.state_dict())
    _same_state(fresh, jm)
    back.load_state_dict(to_jax_state_dict(fresh))
    for m in (jm, back):
        m.update([_jax(p) for p in preds[6:]], [_jax(t) for t in targets[6:]])
    fresh.update([_torch(p) for p in preds[6:]], [_torch(t) for t in targets[6:]])
    _same_state(fresh, jm)
    _same_state(fresh, back)
    _same_result(fresh.compute(), jm.compute())


def test_two_rank_sync_with_an_empty_rank_equals_one_process_and_jax():
    """Rank 1 holds no image: the ragged states still gather (its
    placeholders), and each rank's compute is the one-process value."""
    preds, targets = _coco_images(60, 9)

    def make(pkg, to, kwargs):
        def fn(rank, env):
            m = pkg(class_metrics=True, **kwargs)
            m._sync_env = env
            if rank == 0:
                m.update([to(p) for p in preds], [to(t) for t in targets])
            return {k: _np(v) for k, v in m.compute().items()}

        return fn

    single = _both(preds, targets, class_metrics=True)[1].compute()
    touts = run_ranks(make(MeanAveragePrecision, _torch, {"device": "cpu"}), TorchPair)
    jouts = run_ranks(make(JaxMAP, _jax, {}), JaxPair)
    for tv, jv in zip(touts, jouts):
        _same_result(tv, jv)
        _same_result(tv, {k: _np(v) for k, v in single.items()})


def test_host_only_warns_and_runs_eagerly_like_jax():
    assert MeanAveragePrecision.host_only is True
    with pytest.warns(UserWarning, match="host_only") as jax_warned:
        JaxMAP(jit_update=True)
    with pytest.warns(UserWarning, match="host_only") as port_warned:
        tm = MeanAveragePrecision(jit_update=True, device="cpu")
    assert [str(w.message) for w in port_warned] == [str(w.message) for w in jax_warned]
    assert tm._dispatcher is None


def test_exports_are_the_jax_packages_but_the_nets():
    """The top-level ``__all__`` lacks nothing of the JAX package's (the four
    metrics of the nets are in since they were ported); ``functional.__all__``
    and ``detection`` lack nothing."""
    import metrics_tpu as J
    import metrics_tpu.detection as jax_detection
    import metrics_tpu.functional as jF
    import metrics_tpu_torch as M
    import metrics_tpu_torch.detection as detection
    import metrics_tpu_torch.functional as tF

    assert set(J.__all__) - set(M.__all__) == set()
    assert set(jF.__all__) <= set(tF.__all__)
    public = {n for n in dir(jax_detection) if not n.startswith("_") and callable(getattr(jax_detection, n))}
    assert public <= set(dir(detection)) and "MeanAveragePrecision" not in M.__all__
