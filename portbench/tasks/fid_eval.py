"""FID evaluation of a generator's samples through the program's ``FrechetInceptionDistance``.

The timed path is a generator trainer's scoring of one checkpoint: ``reset()`` (the real side's
statistics kept, ``reset_real_features=False``), one ``update(images, real=False)`` a batch of the
generated samples with no host read between them, then ``compute()``, whose value is read to the host.
The metric takes the configuration's ``metric`` arguments and the bundled
``InceptionV3FeatureExtractor`` with its ``extractor`` arguments, whose weights are the reference's
seeded state dict, written as a ``.pth`` and loaded through ``weights_path=``; its moment sums are
kept in the configuration's ``moment_dtype`` (``set_dtype``). In set-up the real side's
images are made batch by batch from the seed and updated once.

The check, once the window has closed and the program is freed, for every epoch the window ran,
against :mod:`portbench.references.fid_inception` over the same images: the generated side's mean
feature (``fake_features_sum / n``) relative to the features' scale, the FID relative to the
reference's, and the generated images counted.
"""
import contextlib
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import Tensor

from portbench.references import fid_inception as reference
from portbench.traffic import fid as traffic

REFERENCE_CHUNK = 200  # images a reference forward


class Task:
    def __init__(self, config: Dict, mix: Dict, seed: int, device: torch.device) -> None:
        self.config, self.mix, self.seed, self.device = config, mix, seed, device
        self.geometry = traffic.Geometry(config, mix)
        self.pool = traffic.make_pool(self.geometry, mix, seed, device)
        self.input_bytes = self.pool.numel() * self.pool.element_size()
        self.state = reference.seeded_state_dict(seed)
        self.metric = None
        self.epochs: List[Tuple[float, Tensor, int]] = []  # FID, fake_features_sum, fake_num_samples
        self.compute_ms: List[float] = []
        self.mark: Callable[[str], contextlib.AbstractContextManager] = lambda name: contextlib.nullcontext()
        self._reference: Dict[str, Dict[str, object]] = {}

    # ------------------------------------------------------------ program
    def build(self) -> None:
        import metrics_tpu_torch as program
        from metrics_tpu_torch.image.inception_net import InceptionV3FeatureExtractor

        with tempfile.TemporaryDirectory() as tmp:
            weights = str(Path(tmp) / "pt_inception_seeded.pth")
            torch.save(self.state, weights)
            extractor = InceptionV3FeatureExtractor(weights_path=weights, **self.config["extractor"])
        self.metric = program.FrechetInceptionDistance(feature_extractor=extractor, device=self.device,
                                                       **self.config["metric"])
        self.metric.set_dtype(getattr(torch, self.config["moment_dtype"]))
        for batch in traffic.real_batches(self.geometry, self.mix, self.seed, self.device):
            self.metric.update(batch, real=True)

    def warm(self) -> None:
        """Every update shape of the epoch, twice, each pass followed by a compute: the engine builds a
        program on its first call of a shape and may build again once the state is its own."""
        sizes = sorted(set(self.geometry.sizes), reverse=True)
        for _ in range(2):
            self.metric.reset()
            for n in sizes:
                self.metric.update(self.pool[:n], real=False)
            float(self.metric.compute())
        self.metric.reset()

    def retraces(self) -> int:
        return int(self.metric.dispatch_stats["retraces"])

    def epoch(self, time_compute: bool = False) -> int:
        """One checkpoint's scoring; returns the images it updated. With ``time_compute`` the device is
        drained before the compute, whose host time to the value's arrival is kept in ``compute_ms``."""
        fid = self.metric
        with self.mark("portbench.reset"):
            fid.reset()
        for batch in traffic.update_batches(self.pool, self.geometry):
            with self.mark("portbench.update"):
                fid.update(batch, real=False)
        with self.mark("portbench.compute"):
            if time_compute:
                _synchronize(self.device)
                t0 = time.perf_counter()
            value = float(fid.compute())
            if time_compute:
                self.compute_ms.append((time.perf_counter() - t0) * 1e3)
            self.epochs.append((value, fid.fake_features_sum.clone(), int(fid.fake_num_samples)))
        return self.geometry.images

    def update_work(self) -> List[Dict[str, float]]:
        """The problem each update of an epoch hands the program: its images and the trunk's input size."""
        return [{"images": n, "size": self.config["extractor"]["resize"]} for n in self.geometry.sizes]

    def free_program(self) -> None:
        self.metric = None

    # ------------------------------------------------------------ check
    def reference_run(self, precision: str = "float32") -> Dict[str, object]:
        """The reference's generated-side mean feature (float64) and FID at ``precision``, computed once."""
        if precision not in self._reference:
            size = self.config["extractor"]["resize"]
            fake = reference.features(self.state, traffic.update_batches(self.pool, self.geometry), precision,
                                      REFERENCE_CHUNK, size)
            real = reference.features(self.state, traffic.real_batches(self.geometry, self.mix, self.seed, self.device),
                                      precision, REFERENCE_CHUNK, size)
            mu_fake, sigma_fake = reference.mean_cov(fake)
            mu_real, sigma_real = reference.mean_cov(real)
            self._reference[precision] = {"mu": mu_fake, "fid": reference.fid(mu_real, sigma_real, mu_fake, sigma_fake),
                                          "n": fake.shape[0]}
        return self._reference[precision]

    def readings(self, control: object = False) -> List[Dict[str, float]]:
        """Each epoch's compared numbers: the program's, or the control's in its place (``True``: the
        reference with TF32 on; or a precision of :data:`reference.PRECISIONS` by name)."""
        truth = self.reference_run()
        scale = float(truth["mu"].abs().max())
        stand_in: Optional[Dict[str, object]] = None
        if control:
            stand_in = self.reference_run(reference.CONTROL if control is True else str(control))
        out = []
        for value, fake_sum, n in self.epochs:
            if stand_in is not None:
                mu, value, n = stand_in["mu"], stand_in["fid"], stand_in["n"]
            else:
                mu = fake_sum.double() / max(n, 1)
            out.append({"mu_max_rel_gap": float((mu.to(truth["mu"].device) - truth["mu"]).abs().max()) / scale,
                        "fid_rel_gap": abs(value - truth["fid"]) / abs(truth["fid"]),
                        "n_fake_gap": float(abs(n - self.geometry.images))})
        return out


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
