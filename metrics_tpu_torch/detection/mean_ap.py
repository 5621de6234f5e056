"""COCO mean average precision and recall: port of ``metrics_tpu/detection/mean_ap.py``.

The pycocotools evaluation protocol, as the JAX package runs it: IoU
thresholds 0.50:0.05:0.95, the recall grid 0:0.01:1, at most (1, 10, 100)
detections an image, and the area ranges all, small, medium and large.

An update appends each image's boxes (converted to xyxy), scores and labels
to five list states, one element an image. ``compute`` fetches all of them in
one device-to-host copy, then evaluates on the host in float64 numpy: the
small IoU matrices of each (image, class), the greedy matching of detections
to ground truths over every IoU threshold at once in the edit-distance core
(``native.coco_match``), at the largest detection cap (a smaller cap's
matches are a prefix of those), and the precision envelopes. The result
reaches the device in one copy: float32 values and int32 classes, the JAX
package's dtypes. ``host_only``.
"""
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch import native
from metrics_tpu_torch.detection.helpers import box_convert
from metrics_tpu_torch.functional.text.helper import _to_device
from metrics_tpu_torch.metric import Metric

# (state, key of the host dict, trailing shape, dtype, lengths group)
_STATES = (
    ("detection_boxes", "det_boxes", (4,), torch.float32, "detections"),
    ("detection_scores", "det_scores", (), torch.float32, "detections"),
    ("detection_labels", "det_labels", (), torch.int32, "detections"),
    ("groundtruth_boxes", "gt_boxes", (4,), torch.float32, "groundtruths"),
    ("groundtruth_labels", "gt_labels", (), torch.int32, "groundtruths"),
)


def _box_iou_np(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """Pairwise IoU on the host, with ``helpers.box_iou``'s semantics."""
    if boxes1.shape[0] == 0 or boxes2.shape[0] == 0:
        return np.zeros((boxes1.shape[0], boxes2.shape[0]))
    area1 = (boxes1[:, 2] - boxes1[:, 0]) * (boxes1[:, 3] - boxes1[:, 1])
    area2 = (boxes2[:, 2] - boxes2[:, 0]) * (boxes2[:, 3] - boxes2[:, 1])
    lt = np.maximum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = np.minimum(boxes1[:, None, 2:], boxes2[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[:, None] + area2[None, :] - inter
    return np.where(union > 0, inter / np.where(union > 0, union, 1.0), 0.0)


def _input_validator(preds: Sequence[Dict[str, Tensor]], targets: Sequence[Dict[str, Tensor]]) -> None:
    """Validate the list-of-dict detection format."""
    if not isinstance(preds, Sequence):
        raise ValueError("Expected argument `preds` to be of type Sequence")
    if not isinstance(targets, Sequence):
        raise ValueError("Expected argument `target` to be of type Sequence")
    if len(preds) != len(targets):
        raise ValueError("Expected argument `preds` and `target` to have the same length")

    for k in ("boxes", "scores", "labels"):
        if any(k not in p for p in preds):
            raise ValueError(f"Expected all dicts in `preds` to contain the `{k}` key")
    for k in ("boxes", "labels"):
        if any(k not in p for p in targets):
            raise ValueError(f"Expected all dicts in `target` to contain the `{k}` key")


def _by_class(labels: np.ndarray) -> Dict[int, np.ndarray]:
    """Each class's positions in ``labels``, in their order."""
    order = np.argsort(labels, kind="stable")
    classes, starts = np.unique(labels[order], return_index=True)
    return dict(zip(classes.tolist(), np.split(order, starts[1:])))


class MeanAveragePrecision(Metric):
    """COCO mAP and mAR over accumulated detections.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.detection import MeanAveragePrecision
        >>> preds = [dict(
        ...     boxes=torch.tensor([[258.0, 41.0, 606.0, 285.0]]),
        ...     scores=torch.tensor([0.536]),
        ...     labels=torch.tensor([0]))]
        >>> target = [dict(
        ...     boxes=torch.tensor([[214.0, 41.0, 562.0, 285.0]]),
        ...     labels=torch.tensor([0]))]
        >>> metric = MeanAveragePrecision(device="cpu")
        >>> metric.update(preds, target)
        >>> result = metric.compute()
        >>> round(float(result["map_50"]), 4)
        1.0
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = True
    host_only = True

    def __init__(
        self,
        box_format: str = "xyxy",
        iou_thresholds: Optional[List[float]] = None,
        rec_thresholds: Optional[List[float]] = None,
        max_detection_thresholds: Optional[List[int]] = None,
        class_metrics: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)

        allowed_box_formats = ("xyxy", "xywh", "cxcywh")
        if box_format not in allowed_box_formats:
            raise ValueError(f"Expected argument `box_format` to be one of {allowed_box_formats}")
        self.box_format = box_format
        self.iou_thresholds = iou_thresholds or np.linspace(0.5, 0.95, 10).tolist()
        self.rec_thresholds = rec_thresholds or np.linspace(0.0, 1.00, 101).tolist()
        self.max_detection_thresholds = sorted(max_detection_thresholds or [1, 10, 100])
        self.bbox_area_ranges = {
            "all": (0.0, 1e10),
            "small": (0.0, 32.0**2),
            "medium": (32.0**2, 96.0**2),
            "large": (96.0**2, 1e10),
        }
        if not isinstance(class_metrics, bool):
            raise ValueError("Expected argument `class_metrics` to be a boolean")
        self.class_metrics = class_metrics

        for attr, _, _, _, _ in _STATES:
            self.add_state(attr, default=[], dist_reduce_fx=None)
        # one list element an image: a sync gathers each state's elements and their lengths and splits them
        # again (Metric._gather_ragged), so a rank that holds no image still joins through the declared
        # placeholder; the states of a lengths group share one lengths gather
        self._ragged_state_specs = {attr: (trailing, dtype, group) for attr, _, trailing, dtype, group in _STATES}

    def update(self, preds: Sequence[Dict[str, Tensor]], target: Sequence[Dict[str, Tensor]]) -> None:
        """Append each image's detections and ground truths (float32 boxes and scores, int32 labels) on the
        metric's device."""
        _input_validator(preds, target)
        floats, ints = dict(device=self.device, dtype=torch.float32), dict(device=self.device, dtype=torch.int32)
        for item in preds:
            self.detection_boxes.append(box_convert(item["boxes"].to(**floats), self.box_format, "xyxy"))
            self.detection_scores.append(item["scores"].to(**floats))
            self.detection_labels.append(item["labels"].to(**ints))
        for item in target:
            self.groundtruth_boxes.append(box_convert(item["boxes"].to(**floats), self.box_format, "xyxy"))
            self.groundtruth_labels.append(item["labels"].to(**ints))

    # -------------------------------------------------------------- internals
    def _host_states(self) -> Dict[str, List[np.ndarray]]:
        """Every image's arrays on the host, in one device-to-host copy: each
        state concatenated, all five as one buffer of 4-byte words, then split
        by the images' lengths (known on the host)."""
        words, layout = [], []
        for attr, key, trailing, dtype, _ in _STATES:
            value = getattr(self, attr)
            lengths = [int(v.shape[0]) if v.ndim else 1 for v in value]
            flat = (torch.cat([v.reshape(-1, *trailing).to(dtype) for v in value]) if value
                    else torch.zeros((0, *trailing), dtype=dtype, device=self.device))
            words.append(flat.reshape(-1).view(torch.int32))
            layout.append((key, trailing, np.float32 if dtype == torch.float32 else np.int32, lengths))
        host = torch.cat(words).cpu().numpy()
        out: Dict[str, List[np.ndarray]] = {}
        start = 0
        for key, trailing, np_dtype, lengths in layout:
            width = int(np.prod(trailing, dtype=np.int64))
            n = sum(lengths) * width
            data = host[start:start + n].view(np_dtype).reshape(-1, *trailing)
            start += n
            out[key] = np.split(data, np.cumsum(lengths)[:-1]) if lengths else []
        return out

    @staticmethod
    def _get_classes(host: Dict[str, List[np.ndarray]]) -> List[int]:
        all_labels = [np.asarray(x) for x in host["det_labels"] + host["gt_labels"] if x.size]
        if not all_labels:
            return []
        return sorted(set(np.concatenate(all_labels).astype(int).tolist()))

    def _evaluate_image(
        self,
        det_boxes: np.ndarray,
        det_scores: np.ndarray,
        gt_boxes: np.ndarray,
        area_rng: Tuple[float, float],
        ious: np.ndarray,
    ) -> Optional[Dict[str, np.ndarray]]:
        """Greedy ground-truth matching for one (image, class) over every IoU threshold.

        Detections in score order claim the best free ground truth above the
        threshold; ground truths outside the area range are ignored: claimed
        only when no valid one qualifies, and never true positives. Matched at
        the largest detection cap; a smaller cap's result is its prefix.
        """
        n_det, n_gt = det_boxes.shape[0], gt_boxes.shape[0]
        if n_det == 0 and n_gt == 0:
            return None

        gt_areas = (gt_boxes[:, 2] - gt_boxes[:, 0]) * (gt_boxes[:, 3] - gt_boxes[:, 1]) if n_gt else np.empty(0)
        gt_ignore = (gt_areas < area_rng[0]) | (gt_areas > area_rng[1])

        # non-ignored ground truths first (pycocotools sorts by the ignore flag)
        gt_order = np.argsort(gt_ignore, kind="stable")
        gt_ignore_sorted = gt_ignore[gt_order]

        order = np.argsort(-det_scores, kind="stable")[: self.max_detection_thresholds[-1]]
        det_boxes = det_boxes[order]
        det_scores = det_scores[order]
        n_det = det_boxes.shape[0]
        ious_sorted = ious[order][:, gt_order] if n_gt and n_det else np.zeros((n_det, n_gt))

        thrs = np.asarray(self.iou_thresholds, dtype=np.float64)
        det_matched, det_matched_ignored = native.coco_match(ious_sorted, gt_ignore_sorted, thrs)

        det_areas = (det_boxes[:, 2] - det_boxes[:, 0]) * (det_boxes[:, 3] - det_boxes[:, 1])
        det_out_of_range = (det_areas < area_rng[0]) | (det_areas > area_rng[1])
        det_ignore = det_matched_ignored | (~det_matched & det_out_of_range[None, :])

        return {
            "scores": det_scores,
            "matched": det_matched & ~det_ignore,
            "ignored": det_ignore,
            "n_gt": int((~gt_ignore).sum()),
        }

    def _calculate(self, class_ids: List[int], host: Dict[str, List[np.ndarray]]):
        """Precision grid (thr, rec, class, area, maxdet) and recall grid (thr, class, area, maxdet)."""
        det_boxes = [np.asarray(x, dtype=np.float64) for x in host["det_boxes"]]
        det_scores = [np.asarray(x, dtype=np.float64) for x in host["det_scores"]]
        gt_boxes = [np.asarray(x, dtype=np.float64) for x in host["gt_boxes"]]
        det_by_class = [_by_class(np.asarray(x).astype(int)) for x in host["det_labels"]]
        gt_by_class = [_by_class(np.asarray(x).astype(int)) for x in host["gt_labels"]]

        n_imgs = len(gt_boxes)
        n_thr = len(self.iou_thresholds)
        n_rec = len(self.rec_thresholds)
        n_cls = len(class_ids)
        n_area = len(self.bbox_area_ranges)
        n_mdet = len(self.max_detection_thresholds)

        precision = -np.ones((n_thr, n_rec, n_cls, n_area, n_mdet))
        recall = -np.ones((n_thr, n_cls, n_area, n_mdet))

        rec_thrs = np.asarray(self.rec_thresholds)
        no_index = np.zeros(0, dtype=np.int64)

        for c_idx, cls in enumerate(class_ids):
            # this class's detections and ground truths, image by image (an image with neither adds nothing)
            per_img = []
            for i in range(n_imgs):
                d_idx, g_idx = det_by_class[i].get(cls, no_index), gt_by_class[i].get(cls, no_index)
                if not len(d_idx) and not len(g_idx):
                    continue
                db, ds, gb = det_boxes[i][d_idx], det_scores[i][d_idx], gt_boxes[i][g_idx]
                per_img.append((db, ds, gb, _box_iou_np(db, gb)))

            for a_idx, area_rng in enumerate(self.bbox_area_ranges.values()):
                results = [self._evaluate_image(db, ds, gb, area_rng, iou) for db, ds, gb, iou in per_img]
                results = [r for r in results if r is not None]
                npig = sum(r["n_gt"] for r in results)
                if npig == 0:
                    continue
                for m_idx, max_det in enumerate(self.max_detection_thresholds):
                    scores = np.concatenate([r["scores"][:max_det] for r in results])
                    matched = np.concatenate([r["matched"][:, :max_det] for r in results], axis=1)
                    ignored = np.concatenate([r["ignored"][:, :max_det] for r in results], axis=1)

                    order = np.argsort(-scores, kind="mergesort")
                    matched = matched[:, order]
                    ignored = ignored[:, order]

                    tps = np.cumsum(matched & ~ignored, axis=1).astype(np.float64)
                    fps = np.cumsum(~matched & ~ignored, axis=1).astype(np.float64)

                    for t in range(n_thr):
                        tp, fp = tps[t], fps[t]
                        rc = tp / npig
                        pr = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
                        recall[t, c_idx, a_idx, m_idx] = rc[-1] if rc.size else 0.0

                        # precision envelope (monotone non-increasing from the right)
                        pr_env = np.maximum.accumulate(pr[::-1])[::-1] if pr.size else pr
                        inds = np.searchsorted(rc, rec_thrs, side="left")
                        q = np.zeros(n_rec)
                        valid = inds < pr_env.size
                        q[valid] = pr_env[inds[valid]]
                        precision[t, :, c_idx, a_idx, m_idx] = q

        return precision, recall

    @staticmethod
    def _mean_over_valid(x: np.ndarray) -> float:
        valid = x > -1
        return float(x[valid].mean()) if valid.any() else -1.0

    def _summarize_results(self, precision: np.ndarray, recall: np.ndarray) -> Tuple[Dict, Dict]:
        """The COCO summary table."""
        area_keys = list(self.bbox_area_ranges.keys())
        last_mdet = len(self.max_detection_thresholds) - 1
        thr50 = self.iou_thresholds.index(0.5) if 0.5 in self.iou_thresholds else None
        thr75 = self.iou_thresholds.index(0.75) if 0.75 in self.iou_thresholds else None

        map_results = {
            "map": self._mean_over_valid(precision[:, :, :, 0, last_mdet]),
            "map_small": self._mean_over_valid(precision[:, :, :, area_keys.index("small"), last_mdet]),
            "map_medium": self._mean_over_valid(precision[:, :, :, area_keys.index("medium"), last_mdet]),
            "map_large": self._mean_over_valid(precision[:, :, :, area_keys.index("large"), last_mdet]),
        }
        map_results["map_50"] = (
            self._mean_over_valid(precision[thr50, :, :, 0, last_mdet]) if thr50 is not None else -1.0
        )
        map_results["map_75"] = (
            self._mean_over_valid(precision[thr75, :, :, 0, last_mdet]) if thr75 is not None else -1.0
        )

        mar_results = {}
        for m_idx, max_det in enumerate(self.max_detection_thresholds):
            mar_results[f"mar_{max_det}"] = self._mean_over_valid(recall[:, :, 0, m_idx])
        for key in ("small", "medium", "large"):
            mar_results[f"mar_{key}"] = self._mean_over_valid(recall[:, :, area_keys.index(key), last_mdet])

        return map_results, mar_results

    def compute(self) -> Dict[str, Tensor]:
        """The COCO metric dict, keys sorted: float32 values and int32 ``classes`` on the metric's device."""
        host = self._host_states()
        classes = self._get_classes(host)
        precision, recall = self._calculate(classes, host)
        map_val, mar_val = self._summarize_results(precision, recall)

        map_per_class = [-1.0]
        mar_per_class = [-1.0]
        if self.class_metrics:
            map_per_class, mar_per_class = [], []
            for c_idx in range(len(classes)):
                cls_prec = precision[:, :, c_idx:c_idx + 1]
                cls_rec = recall[:, c_idx:c_idx + 1]
                cls_map, cls_mar = self._summarize_results(cls_prec, cls_rec)
                map_per_class.append(cls_map["map"])
                mar_per_class.append(cls_mar[f"mar_{self.max_detection_thresholds[-1]}"])

        values = {**map_val, **mar_val}
        per_class = {"map_per_class": map_per_class,
                     f"mar_{self.max_detection_thresholds[-1]}_per_class": mar_per_class}
        class_ids = np.asarray(classes if classes else [-1], dtype=np.int32)
        # one host-to-device copy: the float32 values and the int32 classes as one buffer of 4-byte words
        floats = np.concatenate([np.asarray(list(values.values()), dtype=np.float32),
                                 *(np.asarray(v, dtype=np.float32) for v in per_class.values())])
        host_buf = torch.from_numpy(np.concatenate([floats.view(np.int32), class_ids]))
        buf = _to_device(host_buf, self.device)
        as_float = buf[:floats.size].view(torch.float32)
        out = {k: as_float[i] for i, k in enumerate(values)}
        start = len(values)
        for k, v in per_class.items():
            out[k] = as_float[start:start + len(v)]
            start += len(v)
        out["classes"] = buf[floats.size:]
        return dict(sorted(out.items()))  # the key order of the JAX package's ``device_put`` of its dict
