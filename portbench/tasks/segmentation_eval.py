"""Semantic-segmentation evaluation through one ``MetricCollection`` of the program.

The timed path is a user's validation epoch: ``reset()``, one ``update`` a batch of the val set with
no host read between them, then ``compute()``, whose values are read to the host as a user logs them.
The collection's members and their arguments come from the configuration's ``metrics`` (class names
of ``metrics_tpu_torch``), its own arguments from ``collection``. ``JaccardIndex`` gives the mIoU and
its ``confmat`` state is the accumulated confusion matrix; ``Accuracy`` gives the pixel accuracy.

The check, once the window has closed and the program is freed: for every epoch the window ran, the
program's confusion matrix exactly, and its mIoU and aAcc within their limits, against
:mod:`portbench.references.segmentation` over the same pool batches.
"""
import contextlib
import time
from typing import Callable, Dict, List, Tuple

import torch
from torch import Tensor

from portbench.references import segmentation as reference
from portbench.traffic import segmentation as traffic

# the numbers compared, in the order they are printed
NUMBERS = ("confmat_max_abs_diff", "miou_max_gap", "aacc_max_gap")


class Task:
    def __init__(self, config: Dict, mix: Dict, seed: int, device: torch.device) -> None:
        self.config, self.device = config, device
        self.geometry = traffic.Geometry(config, mix)
        self.pool = traffic.make_pool(config, mix, self.geometry, seed, device)
        self.input_bytes = traffic.pool_bytes(self.pool)
        self.collection = None
        self.g = 0  # updates made in the run, which pick the pool batch
        self.epochs: List[Tuple[int, List[float], Tensor]] = []  # first update, [mIoU, aAcc], confusion matrix
        self.compute_ms: List[float] = []
        self.mark: Callable[[str], contextlib.AbstractContextManager] = lambda name: contextlib.nullcontext()

    # ------------------------------------------------------------ program
    def build(self) -> None:
        import metrics_tpu_torch as program

        members = [getattr(program, name)(device=self.device, **kwargs) for name, kwargs in self.config["metrics"].items()]
        self.collection = program.MetricCollection(members, **self.config["collection"])

    def warm(self) -> None:
        """Every update shape of the epoch, twice, each followed by a compute: the engine builds a program on
        its first call of a shape and may build again once the state is its own."""
        for _ in range(2):
            self.collection.reset()
            for images in sorted(set(self.geometry.sizes)):
                self.collection.update(*traffic.update_batch(self.pool, self.geometry, 0, images))
            torch.stack([v.float() for v in self.collection.compute().values()]).tolist()
        self.collection.reset()

    def retraces(self) -> int:
        return int(self.collection.dispatch_stats["retraces"])

    def epoch(self, time_compute: bool = False) -> int:
        """One validation epoch; returns the images it updated. With ``time_compute`` the device is drained
        before the compute, whose host time to the values' arrival is kept in ``compute_ms``."""
        coll = self.collection
        first = self.g
        with self.mark("portbench.reset"):
            coll.reset()
        for images in self.geometry.sizes:
            batch = traffic.update_batch(self.pool, self.geometry, self.g, images)
            with self.mark("portbench.update"):
                coll.update(*batch)
            self.g += 1
        with self.mark("portbench.compute"):
            if time_compute:
                _synchronize(self.device)
                t0 = time.perf_counter()
            values = coll.compute()
            confmat = coll["JaccardIndex"].confmat.clone()
            answer = torch.stack([values["JaccardIndex"].float(), values["Accuracy"].float()]).tolist()
            if time_compute:
                self.compute_ms.append((time.perf_counter() - t0) * 1e3)
        self.epochs.append((first, answer, confmat))
        return self.geometry.images

    def update_work(self) -> List[Dict[str, float]]:
        """The problem each update of an epoch hands the program: its pixels (rows), the bytes of the
        user's batch as the mix gives it, and the class count."""
        geo = self.geometry
        return [{"rows": n * geo.pixels, "input_bytes": geo.batch_bytes(n), "num_classes": geo.num_classes}
                for n in geo.sizes]

    def free_program(self) -> None:
        self.collection = None

    # ------------------------------------------------------------ check
    def _batch_confmats(self, control: bool) -> Dict[Tuple[int, int], Tensor]:
        """The reference's confusion matrix of each pool batch at each update size, on the host."""
        geo = self.geometry
        out = {}
        for p, (preds, target) in enumerate(self.pool):
            if geo.inputs == "scores":
                pred = reference.predicted(preds, reference.CONTROL_SCORES if control else torch.float32)
            else:
                pred = preds
            per_image = reference.image_confmats(target, pred, geo.num_classes)
            for n in set(geo.sizes):
                out[(p, n)] = per_image[:n].sum(0).cpu()
            del pred, per_image
        return out

    def _epoch_confmat(self, mats: Dict, first: int, dtype: torch.dtype) -> Tensor:
        sizes, pool = self.geometry.sizes, len(self.pool)
        return reference.accumulate([mats[((first + u) % pool, n)] for u, n in enumerate(sizes)], dtype)

    def readings(self, control: bool = False) -> List[Dict[str, float]]:
        """Each epoch's compared numbers: the program's, or with ``control`` the control's in its place."""
        void = self.geometry.void
        truth = self._batch_confmats(control=False)
        lower = self._batch_confmats(control=True) if control else None
        memo: Dict[int, Tuple[Tensor, float, float]] = {}
        out = []
        for first, answer, confmat in self.epochs:
            key = first % len(self.pool)  # epochs that start on the same pool batch see the same batches
            if key not in memo:
                cm = self._epoch_confmat(truth, first, torch.int64)
                memo[key] = (cm, *reference.miou_aacc(cm, void))
            ref_cm, ref_miou, ref_aacc = memo[key]
            if control:
                confmat = self._epoch_confmat(lower, first, reference.CONTROL_COUNTS)
                answer = reference.miou_aacc(confmat, void, reference.CONTROL_VALUES)
            diff = (confmat.cpu().double() - ref_cm.double()).abs().max()
            out.append({"confmat_max_abs_diff": float(diff), "miou_max_gap": abs(answer[0] - ref_miou),
                        "aacc_max_gap": abs(answer[1] - ref_aacc)})
        return out


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
