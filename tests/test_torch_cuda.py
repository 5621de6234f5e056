"""The CUDA kernels against their plain versions on the card.

These tests need an NVIDIA card with ``nvcc`` (a CUDA kernel has no CPU or
interpret mode); elsewhere they skip. On a machine with a card:
``python -m pytest tests/test_torch_cuda.py -m cuda``.
"""
import numpy as np
import pytest
import torch

import metrics_tpu_torch
from metrics_tpu_torch.ops import confusion_matrix_counts, launches, reset_launches, stat_scores_counts
from metrics_tpu_torch.ops.confusion import _confmat_plain
from metrics_tpu_torch.ops.stat_scores import _stat_counts_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [1, 129, 1024])
@pytest.mark.parametrize("c", [2, 40, 1000, 20000])
def test_stat_scores_kernel_equals_plain(card, n, c):
    rng = np.random.RandomState(n + c)
    target = torch.from_numpy(rng.randint(0, c, n).astype(np.int32)).to(card)
    pred = torch.from_numpy(rng.randint(0, c, n).astype(np.int32)).to(card)
    w = torch.from_numpy(rng.randint(0, 2, n).astype(np.int32)).to(card)
    correct = (pred == target) & (w > 0)
    reset_launches()
    got = stat_scores_counts(target, pred, correct, w, c)
    torch.cuda.synchronize()
    assert launches()["stat_scores"] == 1
    for g, r in zip(got, _stat_counts_plain(target, pred, correct, w, c)):
        assert g.dtype == r.dtype == torch.int32 and torch.equal(g, r)


@pytest.mark.parametrize("n", [1, 200, 1024])
@pytest.mark.parametrize("c", [2, 40, 238, 1000])
def test_confusion_kernel_equals_plain(card, n, c):
    rng = np.random.RandomState(n * 7 + c)
    target = torch.from_numpy(rng.randint(-1, c, n).astype(np.int32)).to(card)
    pred = torch.from_numpy(rng.randint(-1, c, n).astype(np.int32)).to(card)
    reset_launches()
    got = confusion_matrix_counts(target, pred, c)
    torch.cuda.synchronize()
    assert launches()["confusion_matrix"] == 1
    ref = _confmat_plain(target, pred, c)
    assert got.dtype == ref.dtype == torch.int32 and torch.equal(got, ref)


def test_metrics_on_the_card_equal_the_cpu(card):
    rng = np.random.RandomState(0)
    batches = [(rng.rand(n, 50).astype(np.float32), rng.randint(0, 50, n)) for n in (256, 256, 100)]
    results = {}
    for device in ("cpu", card):
        acc = metrics_tpu_torch.Accuracy(num_classes=50, average="macro", device=device)
        cm = metrics_tpu_torch.ConfusionMatrix(num_classes=50, update_method="matmul", device=device)
        for p, t in batches:
            p, t = torch.from_numpy(p).to(device), torch.from_numpy(t).to(device)
            acc.update(p, t)
            cm.update(p, t)
        results[str(device)] = (acc.tp.cpu(), acc.compute().cpu(), cm.compute().cpu())
    cpu, gpu = results["cpu"], results[str(card)]
    assert torch.equal(cpu[0], gpu[0]) and torch.equal(cpu[2], gpu[2])
    torch.testing.assert_close(gpu[1], cpu[1], rtol=1e-6, atol=0)
