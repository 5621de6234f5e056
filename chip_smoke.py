"""Drive the PyTorch/CUDA port (``metrics_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and builds every CUDA kernel from ``metrics_tpu_torch/csrc``
   (one ``nvcc`` per source, all at once).
2. Holds each kernel against its plain PyTorch version on the card over the
   JAX package's parity grid plus masked and padded rows: exact equality.
3. Runs the slice: ImageNet-1k validation (50,000 images, 1,000 classes) in
   batches of 1,024 (48 full, one of 848) through ``Accuracy(average="macro")``
   and ``ConfusionMatrix(update_method="matmul")`` with ``update``,
   ``forward``, ``compute``, ``state_dict`` and ``reset``. Each kernel must
   launch once per batch (49 times), and the results must equal the same run
   on the CPU (counts exactly, accuracy to rtol 1e-6) and an independent
   reference computed from the scores.
4. Times each kernel, its plain version and one PyTorch library call at the
   slice's shapes with CUDA events (median of 25 repetitions), beside the
   least time the card's memory allows, and times whole updates.

The scores and labels are made on the card from a seeded generator: a model
whose top-1 hits the label on about 76% of images, with random scores
elsewhere. The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. There is no CPU mode: without a card the
script fails.
"""
import json
import statistics
import subprocess
import sys
import time
import traceback
import warnings

SEED = 0
N_VAL, NUM_CLASSES, BATCH = 50_000, 1000, 1024  # ILSVRC2012 validation
HEADLINE_CLASSES = 128  # bench.py's headline shape, B = 1024
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
REPS, INNER = 25, 20
SLEEP_CYCLES = 20_000_000  # ~10 ms of device time: the host queues a whole repetition behind it

KERNELS = {
    "stat_scores": ("metrics_tpu_torch/csrc/stat_scores.cu", "metrics_tpu/ops/stat_scores.py:39"),
    "confusion_matrix": ("metrics_tpu_torch/csrc/confusion.cu", "metrics_tpu/ops/confusion.py:37"),
}


def check(cond, message):
    if not cond:
        raise RuntimeError(f"chip_smoke: {message}")


def device_ms(torch, fn):
    """Median device time of one call of ``fn``, from CUDA events around
    ``INNER`` back-to-back calls queued behind a device-side sleep, so that
    the host's launch cost does not show unless the call itself waits."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(REPS):
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(INNER):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / INNER)
    return statistics.median(times)


def host_ms(torch, fn):
    """Median wall time of one call of ``fn`` up to the device's completion."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def syncs_per_call(torch, fn):
    """The host<->device synchronisations one call of ``fn`` makes, each as
    ``file:line`` of the innermost line of the port on the stack, from
    PyTorch's sync debug mode."""
    fn()
    # the debug mode's first switch in a process reports a sync of its own
    torch.cuda.set_sync_debug_mode("warn")
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    found = []

    def note(message, *_args, **_kwargs):
        if "synchroniz" in str(message):
            frames = [f for f in traceback.extract_stack() if "metrics_tpu_torch" in f.filename]
            where = frames[-1] if frames else traceback.extract_stack()[-3]
            found.append(f"{where.filename.rsplit('metrics_tpu_torch/', 1)[-1]}:{where.lineno}")

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return found


def device_busy(torch, fn, steps=10):
    """Device kernel time over wall time for ``steps`` calls of ``fn`` under
    ``torch.profiler``, and the kernels by total time; None where the
    profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_kernel = {}
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.time_range.elapsed_us()
    if not by_kernel:
        return None
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    return {
        "steps": steps,
        "wall_us_per_step": wall_us / steps,
        "device_us_per_step": sum(by_kernel.values()) / steps,
        "busy_share": sum(by_kernel.values()) / wall_us,
        "top_kernels_us_per_step": {name[:60]: us / steps for name, us in top},
    }


def stat_inputs(torch, preds, target):
    """The stat_scores kernel's inputs as the macro update builds them."""
    from metrics_tpu_torch.functional.classification.stat_scores import _predicted_classes

    pred_cls = _predicted_classes(preds)
    target_cls = target.to(torch.int32)
    correct = pred_cls == target_cls
    w = torch.ones(preds.shape[0], dtype=torch.int32, device=preds.device)
    return target_cls, pred_cls, correct, w


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; the port is measured on an NVIDIA card only", file=sys.stderr)
        return 1

    from metrics_tpu_torch import Accuracy, ConfusionMatrix
    from metrics_tpu_torch.functional.classification.confusion_matrix import _canonicalize_confmat_labels
    from metrics_tpu_torch.ops import _build, confusion_matrix_counts, launches, reset_launches, stat_scores_counts
    from metrics_tpu_torch.ops.confusion import _confmat_plain
    from metrics_tpu_torch.ops.stat_scores import _stat_counts_plain

    dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain one-hot product stays exact float32

    # ------------------------------------------------------------ 1. the card
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(dev)}")
    t0 = time.perf_counter()
    libs = _build.build()
    print(f"built {', '.join(p.name for p in libs.values())} in {time.perf_counter() - t0:.2f} s")

    # -------------------------------------------------- 2. kernel vs plain
    max_err = {name: 0 for name in KERNELS}
    g = torch.Generator(device=dev).manual_seed(SEED)
    cases = 0
    for n in (0, 1, 100, 128, 129, 512, 1024):
        for c in (2, 7, 33, 40, 238, 239, 1000, 20000):
            target = torch.randint(0, c, (n,), generator=g, device=dev, dtype=torch.int32)
            pred = torch.randint(0, c, (n,), generator=g, device=dev, dtype=torch.int32)
            for masked in (False, True):
                w = (torch.randint(0, 2, (n,), generator=g, device=dev, dtype=torch.int32) if masked
                     else torch.ones(n, dtype=torch.int32, device=dev))
                correct = (pred == target) & (w > 0)
                got = stat_scores_counts(target, pred, correct, w, c)
                ref = _stat_counts_plain(target, pred, correct, w, c)
                for a, b in zip(got, ref):
                    check(a.dtype == b.dtype == torch.int32, f"stat_scores dtype {a.dtype} at n={n} C={c}")
                    check(torch.equal(a, b), f"stat_scores differs from its plain version at n={n} C={c} masked={masked}")
                    max_err["stat_scores"] = max(max_err["stat_scores"], int((a - b).abs().max()) if n else 0)
                cases += 1
            if c * c > 64_000_000:
                continue
            # padding label -1 in both columns: it matches no class
            tpad = torch.where(torch.rand(n, generator=g, device=dev) < 0.1, -1, target)
            ppad = torch.where(torch.rand(n, generator=g, device=dev) < 0.1, -1, pred)
            for t_, p_ in ((target, pred), (tpad.to(torch.int32), ppad.to(torch.int32))):
                got = confusion_matrix_counts(t_, p_, c)
                ref = _confmat_plain(t_, p_, c)
                check(got.dtype == ref.dtype == torch.int32, f"confusion_matrix dtype {got.dtype}")
                check(torch.equal(got, ref), f"confusion_matrix differs from its plain version at n={n} C={c}")
                max_err["confusion_matrix"] = max(max_err["confusion_matrix"], int((got - ref).abs().max()))
                cases += 1
    torch.cuda.synchronize()
    print(f"kernel vs plain: {cases} cases equal, max_abs_err {max_err}")

    # ------------------------------------------------------------ 3. the slice
    g = torch.Generator(device=dev).manual_seed(SEED)
    labels = torch.randint(0, NUM_CLASSES, (N_VAL,), generator=g, device=dev)
    logits = torch.randn(N_VAL, NUM_CLASSES, generator=g, device=dev)
    hit = torch.rand(N_VAL, generator=g, device=dev) < 0.76
    rows = torch.arange(N_VAL, device=dev)
    logits[rows, labels] = torch.where(hit, logits.amax(dim=1) + 1.0, logits[rows, labels])
    scores = torch.softmax(logits, dim=1)
    del logits
    batches = [(scores[i:i + BATCH], labels[i:i + BATCH]) for i in range(0, N_VAL, BATCH)]
    check(len(batches) == 49 and batches[-1][0].shape[0] == 848, "the slice is 48 batches of 1024 and one of 848")

    def run_slice(device, data):
        acc = Accuracy(num_classes=NUM_CLASSES, average="macro", device=device)
        cm = ConfusionMatrix(num_classes=NUM_CLASSES, update_method="matmul", device=device)
        acc.reset()
        cm.reset()
        if device.type == "cuda":
            torch.cuda.synchronize()
        t_start = time.perf_counter()
        for i, (p, t) in enumerate(data):
            if i == len(data) - 1:
                batch_vals = (acc(p, t), cm(p, t))  # forward: one update and the batch's value
            else:
                acc.update(p, t)
                cm.update(p, t)
        values = (acc.compute(), cm.compute())
        if device.type == "cuda":
            torch.cuda.synchronize()
        return acc, cm, batch_vals, values, time.perf_counter() - t_start

    reset_launches()
    acc, cm, batch_vals, values, epoch_s = run_slice(dev, batches)
    counts = launches()
    print(f"slice on the card: 49 batches in {epoch_s * 1e3:.1f} ms, launches {counts}")
    for name in KERNELS:
        check(counts[name] == 49, f"{name} launched {counts[name]} times in the slice, not 49")

    cpu = torch.device("cpu")
    c_acc, c_cm, c_batch_vals, c_values, cpu_s = run_slice(cpu, [(p.cpu(), t.cpu()) for p, t in batches])
    print(f"same slice on the CPU (plain versions): {cpu_s * 1e3:.1f} ms")
    for name in ("tp", "fp", "tn", "fn"):
        a, b = getattr(acc, name), getattr(c_acc, name)
        check(a.dtype == b.dtype == torch.int32 and torch.equal(a.cpu(), b), f"Accuracy.{name} differs from the CPU run")
    check(cm.confmat.dtype == torch.int32 and torch.equal(cm.confmat.cpu(), c_cm.confmat), "confusion matrix differs from the CPU run")
    check(torch.equal(batch_vals[1].cpu(), c_batch_vals[1]), "forward's batch confusion matrix differs from the CPU run")
    for got, ref, what in ((values[0], c_values[0], "accuracy"), (batch_vals[0], c_batch_vals[0], "forward's batch accuracy")):
        check(got.shape == () and bool(torch.isfinite(got)), f"{what} is not a finite scalar: {got}")
        torch.testing.assert_close(got.cpu(), ref, rtol=1e-6, atol=0, msg=f"{what} differs from the CPU run")

    # an independent reference from the scores: argmax labels, a bincount, macro recall
    ref_cm = torch.bincount(labels * NUM_CLASSES + scores.argmax(dim=1), minlength=NUM_CLASSES**2)
    ref_cm = ref_cm.reshape(NUM_CLASSES, NUM_CLASSES)
    check(torch.equal(cm.confmat.long(), ref_cm), "confusion matrix differs from the bincount of argmax labels")
    diag = ref_cm.diag().double()
    support = ref_cm.sum(dim=1).double()
    present = (support + ref_cm.sum(dim=0).double() - diag) > 0
    ref_acc = torch.where(support > 0, diag / support.clamp(min=1), 0.0)[present].mean()
    # float32 (sum of 1000 class scores) against float64: a looser rtol than the CPU comparison
    torch.testing.assert_close(values[0].double(), ref_acc, rtol=1e-5, atol=0, msg="accuracy differs from macro recall")
    bincount_cm = ConfusionMatrix(num_classes=NUM_CLASSES, device=dev)
    for p, t in batches:
        bincount_cm.update(p, t)
    check(torch.equal(bincount_cm.compute(), values[1]), "update_method='bincount' differs from 'matmul'")
    print(f"slice results: macro accuracy {float(values[0]):.6f}, confusion matrix total {int(values[1].sum())}")

    for metric, cls, kwargs in (
        (acc, Accuracy, dict(num_classes=NUM_CLASSES, average="macro")),
        (cm, ConfusionMatrix, dict(num_classes=NUM_CLASSES, update_method="matmul")),
    ):
        metric.persistent(True)
        fresh = cls(device=dev, **kwargs)
        fresh.load_state_dict(metric.state_dict())
        check(torch.equal(fresh.compute(), metric.compute()), f"{cls.__name__} state_dict round trip changed the value")
        metric.reset()
        check(metric._update_count == 0 and all(int(getattr(metric, k).abs().sum()) == 0 for k in metric._defaults),
              f"{cls.__name__}.reset left state behind")
    print("state_dict round trip and reset: ok")

    # ----------------------------------------------------------------- 4. times
    p, t = batches[-2]  # a full batch: B = 1024, C = 1000
    n = p.shape[0]
    target_cls, pred_cls, correct, w = stat_inputs(torch, p, t)
    idx3 = torch.cat([target_cls, pred_cls + NUM_CLASSES, target_cls + 2 * NUM_CLASSES]).long()
    wts3 = torch.cat([w, w, correct.to(torch.int32)]).float()
    t32, p32 = target_cls, pred_cls
    flat = t32.long() * NUM_CLASSES + p32.long()
    for a, b in zip(stat_scores_counts(target_cls, pred_cls, correct, w, NUM_CLASSES),
                    _stat_counts_plain(target_cls, pred_cls, correct, w, NUM_CLASSES)):
        check(torch.equal(a, b), "stat_scores differs from its plain version at the slice's shape")
    check(torch.equal(confusion_matrix_counts(t32, p32, NUM_CLASSES), _confmat_plain(t32, p32, NUM_CLASSES)),
          "confusion_matrix differs from its plain version at the slice's shape")

    rows = []
    timing = {
        "stat_scores": (
            lambda: stat_scores_counts(target_cls, pred_cls, correct, w, NUM_CLASSES),
            lambda: _stat_counts_plain(target_cls, pred_cls, correct, w, NUM_CLASSES),
            lambda: torch.bincount(idx3, weights=wts3, minlength=3 * NUM_CLASSES),
            n * (4 + 4 + 1 + 4) + 3 * NUM_CLASSES * 4,
        ),
        "confusion_matrix": (
            lambda: confusion_matrix_counts(t32, p32, NUM_CLASSES),
            lambda: _confmat_plain(t32, p32, NUM_CLASSES),
            lambda: torch.bincount(flat, minlength=NUM_CLASSES * NUM_CLASSES),
            n * 8 + NUM_CLASSES * NUM_CLASSES * 4,
        ),
    }
    for name, (kernel, plain, library, nbytes) in timing.items():
        # plain, kernel, kernel, plain: each pair within one call, the mean of the two readings
        plain_a, kernel_a, kernel_b, plain_b = (device_ms(torch, f) for f in (plain, kernel, kernel, plain))
        library_ms = device_ms(torch, library)
        source, replaces = KERNELS[name]
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[name], "max_abs_err": max_err[name],
            "ms": (kernel_a + kernel_b) / 2, "plain_ms": (plain_a + plain_b) / 2,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "library_ms": library_ms,
            "shape": {"B": n, "C": NUM_CLASSES},
        })
        print(f"{name} at B={n} C={NUM_CLASSES}: kernel {kernel_a:.5f}/{kernel_b:.5f} ms, "
              f"plain {plain_a:.5f}/{plain_b:.5f} ms, library {library_ms:.5f} ms, bound {rows[-1]['bound_ms']:.6f} ms")

    upd_acc = Accuracy(num_classes=NUM_CLASSES, average="macro", device=dev)
    upd_cm = ConfusionMatrix(num_classes=NUM_CLASSES, update_method="matmul", device=dev)
    updates = {
        "accuracy_update_ms": host_ms(torch, lambda: upd_acc.update(p, t)),
        "confmat_update_ms": host_ms(torch, lambda: upd_cm.update(p, t)),
        "confmat_canonicalize_ms": host_ms(torch, lambda: _canonicalize_confmat_labels(p, t, NUM_CLASSES, 0.5)),
        "accuracy_syncs": syncs_per_call(torch, lambda: upd_acc.update(p, t)),
        "confmat_syncs": syncs_per_call(torch, lambda: upd_cm.update(p, t)),
    }
    for label in ("accuracy", "confmat"):
        updates[f"{label}_syncs_per_update"] = len(updates[f"{label}_syncs"])
    print("updates at B=1024 C=1000: " + json.dumps(updates))
    for label, fn in (("accuracy", lambda: upd_acc.update(p, t)), ("confmat", lambda: upd_cm.update(p, t))):
        print(f"{label} update under torch.profiler: " + json.dumps(device_busy(torch, fn)))
    warm_s = run_slice(dev, batches)[-1]
    print(f"slice on the card, warm: 49 batches in {warm_s * 1e3:.3f} ms")

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    hp = torch.rand(BATCH, HEADLINE_CLASSES, generator=g, device=dev)
    ht = torch.randint(0, HEADLINE_CLASSES, (BATCH,), generator=g, device=dev)
    h_inputs = stat_inputs(torch, hp, ht)
    h_acc = Accuracy(num_classes=HEADLINE_CLASSES, average="macro", device=dev)
    headline = {
        "shape": {"B": BATCH, "C": HEADLINE_CLASSES},
        "accuracy_update_ms": host_ms(torch, lambda: h_acc.update(hp, ht)),
        "stat_scores_kernel_ms": device_ms(torch, lambda: stat_scores_counts(*h_inputs, HEADLINE_CLASSES)),
    }
    print("bench.py headline shape: " + json.dumps(headline))

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
