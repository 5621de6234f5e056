"""The CUDA kernels against their plain versions on the card.

These tests need an NVIDIA card with ``nvcc`` (a CUDA kernel has no CPU or
interpret mode); elsewhere they skip. On a machine with a card:
``python -m pytest tests/test_torch_cuda.py -m cuda``.
"""
import warnings

import numpy as np
import pytest
import torch

import metrics_tpu_torch
from metrics_tpu_torch.ops import (
    binned_stat_scores,
    confusion_matrix_counts,
    countmin_update,
    launches,
    reset_launches,
    sorted_by_preds,
    stat_scores_counts,
)
from metrics_tpu_torch.ops import registry
from metrics_tpu_torch.ops.binned_stats import (
    _binned_stat_scores_kernel,
    _binned_stat_scores_plain,
    binned_branch,
    hist_max_thresholds,
)
from metrics_tpu_torch.ops.retrieval import _WIDEN, L_MAX, _sorted_by_preds_kernel, _sorted_by_preds_plain
from metrics_tpu_torch.ops.sketch_ops import _countmin_plain, countmin_uses_shared
from metrics_tpu_torch.ops.confusion import _confmat_kernel, _confmat_plain, confusion_branch, split_shared_bytes
from metrics_tpu_torch.ops.stat_scores import _ONE_BLOCK_ROWS, _lib, _stat_counts_kernel, _stat_counts_plain

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


def test_stat_scores_kernel_follows_the_flat_index_rule(card):
    # pred_cls == C (a NaN score row) adds to tp[0]; negative targets under w = 0 add nothing
    c = 5
    target = torch.tensor([0, 1, -1, -15, 2, 4], dtype=torch.int32, device=card)
    pred = torch.tensor([c, c, 0, 3, -16, 3 * c], dtype=torch.int32, device=card)
    w = torch.tensor([1, 1, 0, 0, 1, 1], dtype=torch.int32, device=card)
    correct = (pred == target) & (w > 0)
    got = stat_scores_counts(target, pred, correct, w, c)
    for g, r in zip(got, _stat_counts_plain(target, pred, correct, w, c)):
        assert torch.equal(g, r)
    assert int(got[2][0]) == 2


@pytest.mark.parametrize("n", [1, 129, 1024])
@pytest.mark.parametrize("c,t", [(1, 5), (80, 100), (1000, 100), (7, 300)])
def test_binned_stats_kernel_equals_plain(card, n, c, t):
    g = torch.Generator(device=card).manual_seed(n + c + t)
    preds = torch.rand(n, c, generator=g, device=card)
    preds[::3, 0] = float("nan")
    target = torch.randint(0, 2, (n, c), generator=g, device=card)
    thr = torch.rand(t, generator=g, device=card)  # unsorted
    reset_launches()
    got = binned_stat_scores(preds, target, thr)
    torch.cuda.synchronize()
    assert launches()["binned_stats"] == 1
    for a, b in zip(got, _binned_stat_scores_plain(preds, target == 1, thr)):
        assert a.dtype == b.dtype == torch.float32 and torch.equal(a, b)


def _optin(card):
    """The opt-in shared memory of a block on the card."""
    return registry.device_limits(card, _lib(), "stat_scores")[1]


@pytest.mark.parametrize("n", [1, 1024, _ONE_BLOCK_ROWS, _ONE_BLOCK_ROWS + 1])
@pytest.mark.parametrize("c", [128, 1000, "shared limit", "shared limit + 1"])
def test_stat_scores_every_branch_at_both_sides_of_the_plan_limits(card, n, c):
    # the plan's branch, then every other branch that fits, on rows that follow the flat-index rule
    if isinstance(c, str):
        c = _optin(card) // 12 + (1 if c.endswith("+ 1") else 0)
    rng = np.random.RandomState(n + c % 1000)
    target = torch.from_numpy(rng.randint(0, c, n).astype(np.int32)).to(card)
    pred = torch.from_numpy(rng.randint(0, c, n).astype(np.int32)).to(card)
    w = torch.from_numpy(rng.randint(0, 2, n).astype(np.int32)).to(card)
    pred[::5] = c  # a NaN score row: adds to tp[0]
    target[1::7], w[1::7] = -1, 0  # wraps into range with weight 0
    correct = (pred == target) & (w > 0)
    ref = _stat_counts_plain(target, pred, correct, w, c)
    fits = 12 * c <= _optin(card)
    for branch in (None, "block", "shared") if fits else (None,):
        reset_launches()
        got = _stat_counts_kernel(target, pred, correct, w, c, branch=branch)
        torch.cuda.synchronize()
        assert launches()["stat_scores"] == 1
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype == torch.int32 and torch.equal(g, r), (branch, n, c)
    if not fits:
        with pytest.raises(ValueError, match="no 'block' branch"):
            _stat_counts_kernel(target, pred, correct, w, c, branch="block")


_EDGE_POOL = (0.0, -0.0, float("inf"), -float("inf"), float("nan"), 0.5, 1.0)


def _binned_edge_inputs(n, c, t, seed, card):
    """Unsorted thresholds with repeats, NaN, +-0 and +-inf among them; scores on the same 1/16 grid
    (so that many sit exactly on a threshold) with the same specials; targets 0, 1 and 2 (not a positive)."""
    g = torch.Generator(device=card).manual_seed(seed)
    pool = torch.tensor(_EDGE_POOL, device=card)

    def mixed(shape, share):
        grid = torch.round(torch.rand(shape, generator=g, device=card) * 16) / 16
        special = pool[torch.randint(0, pool.numel(), shape, generator=g, device=card)]
        return torch.where(torch.rand(shape, generator=g, device=card) < share, special, grid)

    return mixed((n, c), 0.1), torch.randint(0, 3, (n, c), generator=g, device=card), mixed((t,), 0.3)


@pytest.mark.parametrize(
    "n,c,t,want",
    [
        (1024, 1000, 100, ("hist", False)),  # ImageNet: one block a tile
        (1024, 80, 100, ("hist", False)),  # COCO: one block a tile
        (568, 80, 100, ("hist", False)),  # COCO's last batch
        (1, 7, 1, ("hist", False)),
        (129, 9, 17, ("hist", False)),  # a partial tile and a partial pass
        (1025, 80, 100, ("hist", False)),  # clusters of 2
        (3000, 17, 300, ("hist", False)),  # clusters of 3, thresholds in 10 chunks of 32 bins
        (65535, 8, 100, ("hist", False)),  # the most rows of the packed counters, clusters of 8
        (65536, 8, 100, ("hist", True)),  # one more: the wide counters
        (64, 8, "packed limit", ("hist", False)),
        (64, 8, "packed limit + 1", ("compare", False)),
        (65536, 8, "wide limit", ("hist", True)),
        (65536, 8, "wide limit + 1", ("compare", False)),
    ],
)
def test_binned_stats_both_branches_at_both_sides_of_the_plan_limits(card, n, c, t, want):
    if isinstance(t, str):
        limit = hist_max_thresholds(t.startswith("wide"), _optin(card))
        t = limit + (1 if t.endswith("+ 1") else 0)
    preds, target, thr = _binned_edge_inputs(n, c, t, seed=n + c + t, card=card)
    branch, cluster, wide = binned_branch(n, c, t, card)
    assert (branch, wide) == want
    assert cluster == (1 if n <= 1024 or branch == "compare" else min(8, -(-n // 1024)))
    ref = _binned_stat_scores_plain(preds, target == 1, thr)
    for compare in (False, True):
        reset_launches()
        got = (binned_stat_scores(preds, target, thr) if not compare
               else _binned_stat_scores_kernel(preds, target == 1, thr, compare=True))
        torch.cuda.synchronize()
        assert launches()["binned_stats"] == 1
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype == torch.float32 and a.shape == b.shape == (c, t)
            assert torch.equal(a, b), (n, c, t, compare)


def test_binned_plan_sizes_the_histogram_as_the_kernel_lays_it_out(card):
    from metrics_tpu_torch.ops.binned_stats import _lib as binned_lib, hist_shared_bytes

    hist_bytes = binned_lib().binned_stats_hist_bytes
    for wide in (False, True):
        for t in range(1, 1025):
            assert hist_bytes(t, int(wide)) == hist_shared_bytes(t, wide), (t, wide)


@pytest.mark.parametrize(
    "n,c,t,want",
    [(1024, 1000, 100, "hist"), (4096, 80, 100, "hist, clusters of 4"), (65536, 8, 100, "hist, clusters of 8, wide")],
)
def test_binned_launches_are_counted_by_branch_and_shape(card, n, c, t, want):
    preds, target, thr = _binned_edge_inputs(n, c, t, seed=n + c, card=card)
    reset_launches()
    binned_stat_scores(preds, target, thr)
    _binned_stat_scores_kernel(preds, target == 1, thr, compare=True)
    assert registry.launches_by_shape("binned_stats") == {(want, (n, c, t)): 1, ("compare", (n, c, t)): 1}


def test_stat_scores_launches_are_counted_by_branch_and_shape(card):
    reset_launches()
    for n in (1024, 1024, 848, _ONE_BLOCK_ROWS + 1):
        target = torch.zeros(n, dtype=torch.int32, device=card)
        stat_scores_counts(target, target, target == 0, torch.ones_like(target), 1000)
    assert registry.launches_by_shape("stat_scores") == {
        ("block", (1024, 1000)): 2, ("block", (848, 1000)): 1, ("shared", (_ONE_BLOCK_ROWS + 1, 1000)): 1}


def test_binned_average_precision_on_the_card_equals_the_cpu(card):
    rng = np.random.RandomState(1)
    batches = [(rng.rand(n, 30).astype(np.float32), rng.randint(0, 30, n)) for n in (256, 256, 77)]
    results = {}
    for device in ("cpu", card):
        m = metrics_tpu_torch.BinnedAveragePrecision(num_classes=30, thresholds=50, device="cpu").to(device)
        for p, t in batches:
            m.update(torch.from_numpy(p).to(device), torch.from_numpy(t).to(device))
        results[str(device)] = (m.TPs.cpu(), m.FPs.cpu(), m.FNs.cpu(), [v.cpu() for v in m.compute()])
    cpu, gpu = results["cpu"], results[str(card)]
    assert all(torch.equal(a, b) for a, b in zip(cpu[:3], gpu[:3]))
    for a, b in zip(cpu[3], gpu[3]):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=0)


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


@pytest.mark.parametrize(
    "q,l",
    [(1, 1), (1, 5), (3, 129), (2, 1000), (4, 3000), (64, 1024), (3, 2), (3, 31), (3, 32), (3, 33), (3, 255),
     (3, 257), (2, 1025), (2, 4097), (2, L_MAX), (2, L_MAX + 1)],
)
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32, torch.bool, torch.int64, torch.uint8])
def test_retrieval_sort_kernel_equals_plain(card, q, l, dtype):
    g = torch.Generator(device=card).manual_seed(q * l)
    preds = torch.round(torch.randn(q, l, generator=g, device=card) * 8) / 8  # ties and -0.0
    preds[:, ::7] = float("nan")
    preds[:, 3::11] = -float("inf")
    target = torch.randint(0, 4, (q, l), generator=g, device=card).to(dtype)
    reset_launches()
    got = sorted_by_preds(preds, target)
    torch.cuda.synchronize()
    assert launches()["retrieval_sort"] == 1
    assert got.dtype == dtype
    assert torch.equal(got.cpu(), _sorted_by_preds_plain(preds.cpu(), target.cpu()))
    assert torch.equal(sorted_by_preds(preds[0], target[0]).cpu(), got[0].cpu())


def _edge_rows(kind, q, l, g, card):
    if kind == "all equal":
        return torch.full((q, l), 0.5, device=card)
    if kind == "all nan":
        return torch.full((q, l), float("nan"), device=card)
    # +-0, +-inf and NaN among ties
    pool = torch.tensor([0.0, -0.0, float("inf"), -float("inf"), float("nan"), 1.0, -1.0], device=card)
    return pool[torch.randint(0, pool.numel(), (q, l), generator=g, device=card)]


@pytest.mark.parametrize("kind", ["all equal", "all nan", "mixed"])
@pytest.mark.parametrize("l", [1, 33, 257, 1000, 1024, 4097])
@pytest.mark.parametrize("all_pairs", [False, True])
def test_retrieval_sort_edge_rows_on_both_branches(card, kind, l, all_pairs):
    g = torch.Generator(device=card).manual_seed(l)
    preds = _edge_rows(kind, 3, l, g, card)
    for dtype in (torch.int32, torch.int64, torch.bool):
        target = torch.randint(0, 4, (3, l), generator=g, device=card).to(dtype)
        reset_launches()
        if all_pairs:  # the branch forced at the kernel, labels widened as the public entry widens them
            got = _sorted_by_preds_kernel(preds, target.to(_WIDEN.get(dtype, dtype)), all_pairs=True).to(dtype)
        else:
            got = sorted_by_preds(preds, target)
        torch.cuda.synchronize()
        assert launches()["retrieval_sort"] == 1
        assert torch.equal(got, _sorted_by_preds_plain(preds, target))
        assert torch.equal(got.cpu(), _sorted_by_preds_plain(preds.cpu(), target.cpu()))


def test_retrieval_modules_on_the_card_equal_the_cpu(card):
    rng = np.random.RandomState(2)
    n = 600
    idx, preds, target = rng.randint(0, 40, n), rng.rand(n).astype(np.float32), rng.randint(0, 2, n)
    preds[::37] = np.nan
    for name in ("RetrievalMAP", "RetrievalMRR", "RetrievalNormalizedDCG", "RetrievalPrecision"):
        values = []
        for device in ("cpu", card):
            m = getattr(metrics_tpu_torch, name)(device=device)
            m.update(*(torch.from_numpy(a).to(device) for a in (preds, target, idx)))
            values.append(m.compute().cpu())
        torch.testing.assert_close(values[1], values[0], rtol=1e-6, atol=0)


def _countmin_inputs(n, depth, width, g, card, hot="third"):
    value = torch.randint(0, 50, (depth, width), generator=g, device=card).float()
    bits = torch.randint(-(2**31), 2**31 - 1, (n,), generator=g, device=card, dtype=torch.int32)
    if hot == "third":
        bits[::3] = bits[0].clone()  # a hot key
    elif hot == "all":
        bits[:] = bits[0].clone()  # one hot cell a row
    w = torch.randint(0, 3, (n,), generator=g, device=card).float()
    seeds = torch.randint(-(2**31), 2**31 - 1, (depth,), generator=g, device=card, dtype=torch.int32)
    return value, bits, w, seeds


@pytest.mark.parametrize("n", [1, 100, 65536, 255, 257])
@pytest.mark.parametrize("depth,width", [(2, 128), (4, 1024), (4, 65536), (1, 1000), (8, 1023)])
def test_countmin_kernel_equals_plain(card, n, depth, width):
    g = torch.Generator(device=card).manual_seed(n + width)
    value, bits, w, _ = _countmin_inputs(n, depth, width, g, card)
    seeds = torch.tensor([1, -1640531526, 1013904243, -626627284, 7, 8, 9, 10][:depth], dtype=torch.int32, device=card)
    reset_launches()
    got = countmin_update(value, bits, w, seeds)
    torch.cuda.synchronize()
    assert launches()["countmin"] == 1
    assert torch.equal(got.cpu(), _countmin_plain(value.cpu(), bits.cpu(), w.cpu(), seeds.cpu()))


def test_count_min_heavy_hitters_on_the_card_equals_the_cpu(card):
    rng = np.random.RandomState(3)
    stream = (rng.zipf(1.2, 20000) % 10000).astype(np.float32)
    tables = []
    for device in ("cpu", card):
        m = metrics_tpu_torch.CountMinHeavyHitters(device=device)
        for chunk in np.array_split(stream, 3):
            m.update(torch.from_numpy(chunk).to(device))
        tables.append(m.value.cpu())
    assert torch.equal(tables[0], tables[1])


@pytest.mark.parametrize("n", [1, 255, 257, 65536])
@pytest.mark.parametrize("depth,width", [(1, 1000), (4, 1024), (8, 1023), (4, 65536)])
def test_countmin_single_hot_key_equals_plain(card, n, depth, width):
    g = torch.Generator(device=card).manual_seed(7 * n + width)
    value, bits, w, seeds = _countmin_inputs(n, depth, width, g, card, hot="all")
    got = countmin_update(value, bits, w, seeds)
    assert torch.equal(got, _countmin_plain(value, bits, w, seeds))


@pytest.mark.parametrize("depth,width", [(4, 1024), (8, 1023), (4, 65536)])
def test_countmin_fractional_weights_agree_and_the_shared_branch_repeats(card, depth, width):
    # a few keys a cell, so that float32 sums in two orders stay within rtol 1e-6
    g = torch.Generator(device=card).manual_seed(width)
    value, bits, _, seeds = _countmin_inputs(4096, depth, width, g, card, hot="none")
    w = torch.rand(4096, generator=g, device=card)
    torch.testing.assert_close(countmin_update(value, bits, w, seeds), _countmin_plain(value, bits, w, seeds),
                               rtol=1e-6, atol=0)
    # the shared branch has no atomics: the same input gives the same bits, hot cells included
    value, bits, _, seeds = _countmin_inputs(65536, depth, width, g, card)
    w = torch.rand(65536, generator=g, device=card)
    first = countmin_update(value, bits, w, seeds)
    assert countmin_uses_shared(depth, width, card) == (width < 65536)
    if width < 65536:
        for _ in range(3):
            assert torch.equal(countmin_update(value, bits, w, seeds), first)


def _confusion_inputs(n, c, kind, card):
    """(target, pred) int32 on the card: ``"random"`` labels in [-1, C] (both ends outside the matrix), or
    ``"runs"`` of 512 rows on one cell (every lane of a warp on one cell) with one prediction in 97 off by one."""
    g = torch.Generator(device=card).manual_seed(n + c)
    if kind == "random":
        target = torch.randint(-1, c + 1, (n,), generator=g, device=card, dtype=torch.int32)
        pred = torch.randint(-1, c + 1, (n,), generator=g, device=card, dtype=torch.int32)
        target[::101] = -(2**31)
        pred[1::103] = 2**31 - 1
        return target, pred
    target = (torch.arange(n, device=card) // 512 % c).to(torch.int32)
    pred = target.clone()
    pred[::97] = (pred[::97] + 1) % c
    return target, pred


# up to 2,097,152 rows where the plain one-hot product stays within about 2 GB a side
@pytest.mark.parametrize(
    "n,c", [(n, c) for n in (1, 3, 129, 4099, 65536, 2097152) for c in (2, 20, 240, 241, 1000) if n * c <= 6e8]
)
@pytest.mark.parametrize("kind", ["random", "runs"])
def test_confusion_both_branches_equal_plain(card, n, c, kind):
    target, pred = _confusion_inputs(n, c, kind, card)
    ref = _confmat_plain(target, pred, c)
    runs = [dict(branch="band")]
    if split_shared_bytes(c) <= registry.device_limits(card, _lib(), "stat_scores")[1]:
        runs += [dict(branch="split", blocks=1), dict(branch="split", blocks=8), dict(branch="split", blocks=128)]
    for kwargs in [{}] + runs:
        reset_launches()
        got = _confmat_kernel(target, pred, c, **kwargs)
        torch.cuda.synchronize()
        assert launches()["confusion_matrix"] == 1
        assert got.dtype == torch.int32 and torch.equal(got, ref), kwargs
    # an input that does not start on 16 bytes takes the row-by-row loads
    if n > 4:
        assert torch.equal(confusion_matrix_counts(target[1:], pred[1:], c), _confmat_plain(target[1:], pred[1:], c))


def test_confusion_plan_at_the_path_shapes(card):
    assert confusion_branch(1024, 1000, card) == "band"  # ImageNet's batch
    assert confusion_branch(2097152, 20, card) == "split, 132 blocks"  # a Cityscapes image


@pytest.mark.parametrize("name", ["confusion_matrix", "retrieval_sort", "countmin"])
def test_one_call_records_one_branch_and_shape(card, name):
    g = torch.Generator(device=card).manual_seed(9)
    if name == "confusion_matrix":
        t = torch.randint(0, 20, (2097152,), generator=g, device=card, dtype=torch.int32)
        call, want = (lambda: confusion_matrix_counts(t, t, 20)), ("split, 132 blocks", (2097152, 20))
    elif name == "retrieval_sort":
        p = torch.rand(64, 1000, generator=g, device=card)
        call, want = (lambda: sorted_by_preds(p, p > 0.5)), ("bitonic", (64, 1000))
    else:
        value, bits, w, seeds = _countmin_inputs(65536, 4, 1024, g, card)
        call, want = (lambda: countmin_update(value, bits, w, seeds)), ("shared", (65536, 4, 1024))
    reset_launches()
    call()
    assert registry.launches_by_shape(name) == {want: 1}


def test_confusion_family_on_the_card_equals_the_cpu(card):
    rng = np.random.RandomState(4)
    batches = [(rng.rand(n, 30).astype(np.float32), rng.randint(0, 30, n)) for n in (256, 256, 100)]
    for name, kwargs in (("CohenKappa", dict(weights="quadratic")), ("MatthewsCorrCoef", {}),
                         ("JaccardIndex", dict(ignore_index=3))):
        results = []
        for device in ("cpu", card):
            m = getattr(metrics_tpu_torch, name)(num_classes=30, update_method="matmul", device=device, **kwargs)
            for p, t in batches:
                m.update(torch.from_numpy(p).to(device), torch.from_numpy(t).to(device))
            results.append((m.confmat.cpu(), m.compute().cpu()))
        assert torch.equal(results[0][0], results[1][0])
        torch.testing.assert_close(results[1][1], results[0][1], rtol=1e-6, atol=0)


def _stat_trio(device, c):
    macro = dict(num_classes=c, average="macro", device=device)
    return [metrics_tpu_torch.Accuracy(**macro), metrics_tpu_torch.Precision(**macro), metrics_tpu_torch.Recall(**macro)]


@pytest.mark.parametrize("c", [10, 1000])
def test_grouped_collection_launches_stat_scores_once_a_group(card, c):
    """Three stat-scores metrics in one group: 3 + (n - 1) launches over n updates, against 3n ungrouped;
    the values bit-equal to the ungrouped collection's, the counts to the CPU run's and the values to
    the CPU run's within rtol 1e-6 (float32 sums of the class scores in another order). The eager loop
    (``fused_update=False``): on the card the default is the fused update, which consults no groups."""
    rng = np.random.RandomState(c)
    n = 5
    batches = [(torch.from_numpy(rng.rand(256, c).astype(np.float32)), torch.from_numpy(rng.randint(0, c, 256)))
               for _ in range(n)]
    runs = {}
    for groups in (True, False):
        mc = metrics_tpu_torch.MetricCollection(_stat_trio(card, c), compute_groups=groups, fused_update=False)
        reset_launches()
        for p, t in batches:
            mc.update(p.to(card), t.to(card))
        torch.cuda.synchronize()
        assert launches()["stat_scores"] == (3 + n - 1 if groups else 3 * n)
        runs[groups] = (mc, mc.compute())
    on, off = runs[True][1], runs[False][1]
    assert all(on[k].dtype == off[k].dtype and torch.equal(on[k], off[k]) for k in on)
    cpu = metrics_tpu_torch.MetricCollection(_stat_trio("cpu", c))
    for p, t in batches:
        cpu.update(p, t)
    cpu_values = cpu.compute()
    assert cpu.compute_groups == runs[True][0].compute_groups == {0: ["Accuracy", "Precision", "Recall"]}
    for name in ("tp", "fp", "tn", "fn"):
        assert torch.equal(getattr(runs[True][0]["Recall"], name).cpu(), getattr(cpu["Recall"], name))
    for k in on:
        torch.testing.assert_close(on[k].cpu(), cpu_values[k], rtol=1e-6, atol=0)


def test_stat_family_and_composition_on_the_card_equal_the_cpu(card):
    rng = np.random.RandomState(5)
    batches = [(rng.rand(n, 40).astype(np.float32), rng.randint(0, 40, n)) for n in (256, 256, 100)]
    for name, kwargs in (("Precision", {}), ("Recall", {}), ("F1Score", {}), ("FBetaScore", dict(beta=0.5)),
                         ("Specificity", {}), ("HammingDistance", None)):
        results = []
        for device in ("cpu", card):
            m = getattr(metrics_tpu_torch, name)(device=device, **(
                {} if kwargs is None else dict(num_classes=40, average="macro", **kwargs)))
            for p, t in batches:
                m.update(torch.from_numpy(p).to(device), torch.from_numpy(t).to(device))
            results.append(({k: getattr(m, k).cpu() for k in m._defaults}, m.compute().cpu()))
        assert all(torch.equal(results[0][0][k], results[1][0][k]) for k in results[0][0]), name
        torch.testing.assert_close(results[1][1], results[0][1], rtol=1e-6, atol=0)
    p_, r_ = (getattr(metrics_tpu_torch, n)(num_classes=40, average="macro", device=card) for n in ("Precision", "Recall"))
    comp = 2 * p_ * r_ / (p_ + r_)
    reset_launches()
    for p, t in batches:
        comp.update(torch.from_numpy(p).to(card), torch.from_numpy(t).to(card))
    torch.cuda.synchronize()
    assert launches()["stat_scores"] == 4 * len(batches)  # P and R each stand twice in the tree
    pv, rv = float(p_.compute()), float(r_.compute())
    np.testing.assert_allclose(float(comp.compute()), 2 * pv * rv / (pv + rv), rtol=1e-6)


# ------------------------------------------------------------------ engines
def _scores(rng, n, c, card):
    return (torch.from_numpy(rng.rand(n, c).astype(np.float32)).to(card),
            torch.from_numpy(rng.randint(0, c, n).astype(np.int32)).to(card))


def _no_sync(fn):
    """Run ``fn`` with every host<->device synchronisation an error."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.parametrize("kind", ["accuracy", "confmat", "collection", "countmin"])
def test_engine_updates_replay_without_a_sync_and_equal_eager(card, kind):
    rng = np.random.RandomState(11)
    c = 100
    if kind == "countmin":
        batches = [(torch.from_numpy(rng.randint(0, 500, n).astype(np.float32)).to(card),) for n in (300, 512, 512, 300)]
    else:
        batches = [_scores(rng, n, c, card) for n in (300, 512, 512, 300)]

    def make(engine):
        if kind == "accuracy":
            return metrics_tpu_torch.Accuracy(num_classes=c, average="macro", jit_update=engine, device=card)
        if kind == "confmat":
            return metrics_tpu_torch.ConfusionMatrix(c, update_method="matmul", jit_update=engine, device=card)
        if kind == "countmin":
            return metrics_tpu_torch.CountMinHeavyHitters(jit_update=engine, device=card)
        return metrics_tpu_torch.MetricCollection(
            [metrics_tpu_torch.Accuracy(num_classes=c, average="macro", device=card),
             metrics_tpu_torch.HammingDistance(device=card),
             metrics_tpu_torch.CohenKappa(c, update_method="matmul", device=card)], fused_update=engine)

    engine, eager = make(True), make(False)
    for b in batches[:2]:  # builds every program: one a bucket (300 shares 512's) or one a shape
        engine.update(*b)
    for b in batches[2:]:
        _no_sync(lambda b=b: engine.update(*b))
    for b in batches:
        eager.update(*b)
    members = engine.values() if kind == "collection" else [engine]
    others = eager.values() if kind == "collection" else [eager]
    for m, e in zip(members, others):
        for k in m._defaults:
            assert torch.equal(getattr(m, k), getattr(e, k)), (type(m).__name__, k)
    stats = engine.dispatch_stats
    assert stats["dispatches"] == len(batches) and stats["demotions"] == 0 and not stats["permanent"]


def test_engine_launch_counts_are_the_kernels_run(card):
    rng = np.random.RandomState(12)
    acc = metrics_tpu_torch.Accuracy(num_classes=1000, average="macro", jit_update=True, device=card)
    cm = metrics_tpu_torch.ConfusionMatrix(1000, update_method="matmul", jit_update=True, device=card)
    reset_launches()
    for n in (1024, 1024, 848, 1024, 848):
        p, t = _scores(rng, n, 1000, card)
        acc.update(p, t)
        cm.update(p, t)
    torch.cuda.synchronize()
    assert launches()["stat_scores"] == 5 and launches()["confusion_matrix"] == 5
    assert acc.dispatch_stats["retraces"] == 1 and cm.dispatch_stats["retraces"] == 2
    # the masked program launches at the bucket's shape, the exact ones at each batch's
    assert registry.launches_by_shape("stat_scores") == {("block", (1024, 1000)): 5}
    assert registry.launches_by_shape("confusion_matrix") == {("band", (1024, 1000)): 3, ("band", (848, 1000)): 2}


def test_split_branch_ticket_is_right_under_two_graphs_and_eager_launches(card):
    c, rows = 20, (65536, 131072)
    g = torch.Generator(device=card).manual_seed(3)
    engine = metrics_tpu_torch.JaccardIndex(c, update_method="matmul", jit_update=True, device=card)
    total = torch.zeros(c * c, dtype=torch.int64, device=card)
    for step in range(6):
        n = rows[step % 2]
        target = torch.randint(0, c, (n,), generator=g, device=card, dtype=torch.int32)
        pred = torch.where(torch.rand(n, generator=g, device=card) < 0.9, target,
                           torch.randint(0, c, (n,), generator=g, device=card, dtype=torch.int32))
        assert confusion_branch(n, c, card).startswith("split, ")
        engine.update(pred, target)  # a graph of each shape, replayed in turns
        eager = confusion_matrix_counts(target, pred, c)  # the current stream's own ticket, between replays
        total += torch.bincount(target.long() * c + pred.long(), minlength=c * c)
        assert torch.equal(eager.long().reshape(-1), torch.bincount(target.long() * c + pred.long(), minlength=c * c))
    assert torch.equal(engine.confmat.long().reshape(-1), total)
    assert engine.dispatch_stats["retraces"] == 2


@pytest.mark.parametrize("full_state_update", [False, True])
def test_forward_value_is_a_copy_that_the_next_step_leaves_alone(card, full_state_update):
    rng = np.random.RandomState(13)

    class Acc(metrics_tpu_torch.Accuracy):
        pass

    Acc.full_state_update = full_state_update
    engine = Acc(num_classes=50, average="macro", jit_update=True, device=card)
    eager = Acc(num_classes=50, average="macro", device=card)
    values = []
    for n in (64, 40, 64, 33):
        p, t = _scores(rng, n, 50, card)
        values.append((engine(p, t), eager(p, t)))
    for got, want in values:  # each step's value as it was, after the later steps
        assert torch.equal(got, want)
    assert engine.forward_stats["launches"] == 4 and engine.forward_stats["retraces"] == 1
    for k in engine._defaults:
        assert torch.equal(getattr(engine, k), getattr(eager, k))


def test_engine_scan_update_equals_the_update_loop(card):
    rng = np.random.RandomState(14)
    m = metrics_tpu_torch.Accuracy(num_classes=30, average="macro", device=card)
    p = torch.from_numpy(rng.rand(6, 128, 30).astype(np.float32)).to(card)
    t = torch.from_numpy(rng.randint(0, 30, (6, 128)).astype(np.int32)).to(card)
    first = m.scan_update(m.default_state(), p, t)
    second = m.scan_update(first, p, t)  # a replay: the first result is held, not overwritten
    for i in range(6):
        m.update(p[i], t[i])
    for k in m._defaults:
        assert torch.equal(first[k], getattr(m, k))
        assert torch.equal(second[k], 2 * getattr(m, k))


def test_a_capture_survives_unreferenced_engine_metrics_collected_around_it(card):
    """Engine metrics sit in reference cycles (the dispatcher's closures hold
    the metric), so their graphs are freed by the garbage collector; one that
    ran during a capture would destroy a graph mid-capture and spoil it."""
    import gc

    rng = np.random.RandomState(15)
    p, t = _scores(rng, 256, 30, card)
    for _ in range(3):
        metrics_tpu_torch.Accuracy(num_classes=30, average="macro", jit_update=True, device=card).update(p, t)
    threshold = gc.get_threshold()
    gc.set_threshold(1)  # a collection at almost every allocation
    try:
        m = metrics_tpu_torch.ConfusionMatrix(30, update_method="matmul", jit_update=True, device=card)
        for _ in range(3):
            m.update(p, t)
    finally:
        gc.set_threshold(*threshold)
    assert m.dispatch_stats["demotions"] == 0 and m.dispatch_stats["retraces"] == 1
    ref = torch.bincount(t.long() * 30 + p.argmax(dim=1), minlength=900).reshape(30, 30)
    assert torch.equal(m.confmat.long(), 3 * ref)


def test_state_and_group_members_keep_their_values_across_engine_replays(card):
    """A replay writes the engine's buffers in place: ``state()`` and a
    compute-group member's adopted leaves are copies, so later replays leave
    them as they were."""
    rng = np.random.RandomState(16)
    batches = [_scores(rng, 512, 40, card) for _ in range(4)]
    m = metrics_tpu_torch.Accuracy(num_classes=40, average="macro", jit_update=True, device=card)
    m.update(*batches[0])
    held = m.state()
    saved = {k: v.clone() for k, v in held.items()}
    for b in batches[1:]:
        m.update(*b)
    assert all(torch.equal(held[k], saved[k]) for k in saved)
    leader = metrics_tpu_torch.Accuracy(num_classes=40, average="macro", jit_update=True, device=card)
    member = metrics_tpu_torch.Recall(num_classes=40, average="macro", jit_update=True, device=card)
    mc = metrics_tpu_torch.MetricCollection([leader, member], fused_update=False)
    for b in batches[:2]:
        mc.update(*b)  # groups formed: the leader's engine updates for both
    value = mc.compute()["Recall"]
    member_tp = member.tp.clone()
    for b in batches[2:]:
        leader.update(*b)  # replays outside the collection: the member's adopted state stays
    assert torch.equal(member.tp, member_tp) and torch.equal(member.compute(), value)


@pytest.mark.parametrize("kind", ["confmat", "sum", "collection"])
def test_compute_values_keep_their_values_across_reset_and_replays(card, kind):
    """``ConfusionMatrix.compute`` (``normalize=None``) and ``SumMetric.compute``
    return a state leaf, which under the engine is a graph's buffer: the value
    is a copy, so an epoch's result held across ``reset`` and the next epoch's
    replays stays that epoch's."""
    rng = np.random.RandomState(17)
    c = 40
    epochs = [[_scores(rng, 512, c, card) for _ in range(3)] for _ in range(2)]
    if kind == "confmat":
        m = metrics_tpu_torch.ConfusionMatrix(c, update_method="matmul", jit_update=True, device=card)
    elif kind == "sum":
        m = metrics_tpu_torch.SumMetric(jit_update=True, device=card)
    else:
        m = metrics_tpu_torch.MetricCollection(
            [metrics_tpu_torch.ConfusionMatrix(c, update_method="matmul", device=card),
             metrics_tpu_torch.Accuracy(num_classes=c, average="macro", device=card)])  # fused on the card

    def step(b):
        m.update(b[0].sum(dim=1)) if kind == "sum" else m.update(*b)

    held, saved = [], []
    for batches in epochs:
        for i, b in enumerate(batches):
            step(b)
            if i == 0:  # within an epoch: a value taken mid-epoch, then two more updates
                mid = m.compute()
                held.append(mid)
                saved.append({k: v.clone() for k, v in mid.items()} if kind == "collection" else mid.clone())
        value = m.compute()
        held.append(value)
        saved.append({k: v.clone() for k, v in value.items()} if kind == "collection" else value.clone())
        m.reset()
    for b in epochs[0]:  # and replays after the last reset
        step(b)
    torch.cuda.synchronize()
    for got, want in zip(held, saved):
        if kind == "collection":
            assert all(torch.equal(got[k], want[k]) for k in want)
        else:
            assert torch.equal(got, want)
    stats = m.dispatch_stats
    assert stats["retraces"] >= 1 and stats["demotions"] == 0


# ------------------------------------------- slice 10: curves, calibration, ranking
def _slice10_runs(device):
    """Every slice-10 module on one seeded epoch on ``device``: the values on the CPU."""
    rng = np.random.RandomState(40)
    logits = rng.randn(3, 100, 12).astype(np.float32)
    scores = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    labels = rng.randint(0, 12, (3, 100))
    ml_target = rng.randint(0, 2, (3, 100, 12))
    binary = np.round(rng.rand(3, 100) * 16) / 16
    bin_target = rng.randint(0, 2, (3, 100))
    M = metrics_tpu_torch
    mods = {
        "auroc": M.AUROC(num_classes=12, device=device),
        "auroc_weighted": M.AUROC(num_classes=12, average="weighted", device=device),
        "auroc_ml_micro": M.AUROC(num_classes=12, average="micro", device=device),
        "auroc_pauc": M.AUROC(pos_label=1, max_fpr=0.1, device=device),
        "roc": M.ROC(num_classes=12, device=device),
        "ece": M.CalibrationError(device=device),
        "rmsce": M.CalibrationError(norm="l2", device=device),
        "hinge": M.HingeLoss(device=device),
        "kl": M.KLDivergence(device=device),
        "kl_none": M.KLDivergence(reduction="none", device=device),
        "coverage": M.CoverageError(device=device),
        "lrap": M.LabelRankingAveragePrecision(device=device),
        "lrl": M.LabelRankingLoss(device=device),
    }
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)  # noqa: E731
    for b in range(3):
        s, y = t(scores[b]), t(labels[b])
        for key in ("auroc", "auroc_weighted", "roc", "ece", "rmsce"):
            mods[key].update(s, y)
        mods["auroc_ml_micro"].update(s, t(ml_target[b]))
        mods["auroc_pauc"].update(t(binary[b].astype(np.float32)), t(bin_target[b]))
        mods["hinge"].update(torch.log(s), y)
        mods["kl"].update(s, t(scores[(b + 1) % 3]))
        mods["kl_none"].update(s, t(scores[(b + 1) % 3]))
        for key in ("coverage", "lrap", "lrl"):
            mods[key].update(s, t(ml_target[b]))
    out = {}
    for key, m in mods.items():
        v = m.compute()
        out[key] = [[c.cpu() for c in x] for x in v] if key == "roc" else v.cpu()
    out["dice"] = metrics_tpu_torch.functional.dice_score(t(scores.reshape(-1, 12)), t(labels.reshape(-1))).cpu()
    out["auc"] = metrics_tpu_torch.functional.auc(t(np.linspace(0, 1, 50, dtype=np.float32)), t(rng.rand(50).astype(np.float32))).cpu()
    return out


def test_slice10_modules_on_the_card_equal_the_cpu(card):
    cpu, gpu = _slice10_runs("cpu"), _slice10_runs(card)
    for key in cpu:
        if key == "roc":
            for a, b in zip(cpu[key], gpu[key]):  # fpr, tpr and thresholds a class: the same curves
                for x, y in zip(a, b):
                    assert torch.equal(x, y), key
            continue
        torch.testing.assert_close(gpu[key], cpu[key], rtol=1e-6, atol=0, msg=key)


def test_compute_on_cpu_moves_the_list_states_off_the_card(card):
    rng = np.random.RandomState(41)
    batches = [(torch.from_numpy(rng.rand(64, 6).astype(np.float32)).to(card), torch.from_numpy(rng.randint(0, 6, 64)).to(card))
               for _ in range(3)]
    on_card = metrics_tpu_torch.AUROC(num_classes=6, device=card)
    moved = metrics_tpu_torch.AUROC(num_classes=6, compute_on_cpu=True, device=card)
    ce = metrics_tpu_torch.CalibrationError(compute_on_cpu=True, device=card)
    assert ce.bin_boundaries.device.type == "cuda"
    for p, t in batches:
        on_card.update(p, t)
        moved.update(p, t)
        ce.update(p, t)
        assert all(v.device.type == "cpu" for v in moved.preds + moved.target + ce.confidences)
    value = moved.compute()
    assert value.device.type == "cpu"
    torch.testing.assert_close(value, on_card.compute().cpu(), rtol=1e-6, atol=0)
    ce_card = metrics_tpu_torch.CalibrationError(device="cpu").to(card)  # the boundaries follow .to()
    assert ce_card.bin_boundaries.device.type == "cuda"
    for p, t in batches:
        ce_card.update(p, t)
    torch.testing.assert_close(ce.compute(), ce_card.compute().cpu(), rtol=1e-6, atol=0)


# ------------------------------------------------- slice 11: regression and pairwise
REGRESSION_ENGINE = {
    "mse": ("MeanSquaredError", {}), "mae": ("MeanAbsoluteError", {}), "msle": ("MeanSquaredLogError", {}),
    "mape": ("MeanAbsolutePercentageError", {}), "smape": ("SymmetricMeanAbsolutePercentageError", {}),
    "wmape": ("WeightedMeanAbsolutePercentageError", {}), "tweedie": ("TweedieDevianceScore", {"power": 1.5}),
    "r2": ("R2Score", {}), "explained_variance": ("ExplainedVariance", {}), "pearson": ("PearsonCorrCoef", {}),
}


def _regression_batches(card, n=4, rows=4096, seed=50):
    g = torch.Generator(device=card).manual_seed(seed)
    out = []
    for _ in range(n):
        target = 0.5 + 9.5 * torch.rand(rows, generator=g, device=card)
        out.append((target * torch.exp(0.1 * torch.randn(rows, generator=g, device=card)), target))
    return out


@pytest.mark.parametrize("case", sorted(REGRESSION_ENGINE))
def test_regression_engine_replays_without_a_sync_and_equal_eager(card, case):
    cls, kwargs = REGRESSION_ENGINE[case]
    batches = _regression_batches(card)
    engine = getattr(metrics_tpu_torch, cls)(jit_update=True, device=card, **kwargs)
    eager = getattr(metrics_tpu_torch, cls)(device=card, **kwargs)
    engine.update(*batches[0])
    for b in batches[1:]:
        _no_sync(lambda b=b: engine.update(*b))
    for b in batches:
        eager.update(*b)
    for k in eager._defaults:
        assert torch.equal(getattr(engine, k), getattr(eager, k)), k
    assert torch.equal(engine.compute(), eager.compute())
    stats = engine.dispatch_stats
    assert stats["dispatches"] == len(batches) and stats["retraces"] == 1 and stats["demotions"] == 0


@pytest.mark.parametrize("case", ["mse", "pearson"])
def test_regression_fused_forward_equals_eager_forward_without_a_sync(card, case):
    """MSE merges its batch state by its reductions, Pearson (``full_state_update``) updates twice."""
    cls, kwargs = REGRESSION_ENGINE[case]
    batches = _regression_batches(card, seed=51)
    engine = getattr(metrics_tpu_torch, cls)(jit_update=True, device=card, **kwargs)
    eager = getattr(metrics_tpu_torch, cls)(device=card, **kwargs)
    values = [engine(*batches[0])]
    for b in batches[1:]:
        _no_sync(lambda b=b: values.append(engine(*b)))
    for b, v in zip(batches, values):
        assert torch.equal(v, eager(*b))
    for k in eager._defaults:
        assert torch.equal(getattr(engine, k), getattr(eager, k)), k
    assert engine.forward_stats["launches"] == len(batches) and engine.forward_stats["demotions"] == 0


def _depth_collection(card, fused):
    M = metrics_tpu_torch
    return M.MetricCollection({
        "mse": M.MeanSquaredError(device=card), "rmse": M.MeanSquaredError(squared=False, device=card),
        "mae": M.MeanAbsoluteError(device=card), "msle": M.MeanSquaredLogError(device=card),
        "abs_rel": M.MeanAbsolutePercentageError(device=card), "r2": M.R2Score(device=card),
        "explained_variance": M.ExplainedVariance(device=card)}, prefix="depth_", fused_update=fused)


def test_depth_collection_fused_update_equals_eager_without_a_sync(card):
    batches = _regression_batches(card, seed=52)
    fused, eager = _depth_collection(card, True), _depth_collection(card, False)
    fused.update(*batches[0])
    for b in batches[1:]:
        _no_sync(lambda b=b: fused.update(*b))
    for b in batches:
        eager.update(*b)
    assert fused.dispatch_stats["dispatches"] == len(batches) and fused.dispatch_stats["demotions"] == 0
    a, b = fused.compute(), eager.compute()
    assert list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)


def test_spearman_ranks_on_the_card_are_the_cpus(card):
    """Ties, NaN, +-0 and +-inf: the card's stable sort and scatter-add give
    the CPU's bits while every tie group's rank sum is below 2**24 (here
    groups of up to ~400 values at ranks up to 20,000). Past it the card adds
    a group's ranks in another order: a rank of a group of ``k`` values is
    then within ``k * 2**-24`` of the CPU's, relatively (the second case: the
    value 0 of ``round(4 * randn)`` is ~2,100 values at ranks near 10,000)."""
    from metrics_tpu_torch.functional.regression.spearman import _rank_data

    rng = np.random.RandomState(53)
    for scale, exact in ((40, True), (4, False)):
        data = np.round(rng.randn(20000) * scale).astype(np.float32)
        data[::37], data[1::211], data[2::211], data[3::101], data[4::103] = np.nan, -0.0, 0.0, np.inf, -np.inf
        cpu = torch.from_numpy(data)
        got, want = _rank_data(cpu.to(card)).cpu(), _rank_data(cpu)
        not_nan = ~np.isnan(data)
        _, inverse, sizes = np.unique(data[not_nan], return_inverse=True, return_counts=True)
        largest = int(sizes.max())
        sums = want[torch.from_numpy(not_nan)].double() * torch.from_numpy(sizes[inverse]).double()
        assert (float(sums.max()) < 2**24) is exact, float(sums.max())
        if exact:
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=largest * 2.0**-24, atol=0)
    g = torch.Generator(device=card).manual_seed(54)
    preds, target = torch.rand(3000, generator=g, device=card), torch.randint(0, 26, (3000,), generator=g, device=card)
    target = target.float() / 5
    got = metrics_tpu_torch.functional.spearman_corrcoef(preds, target)
    torch.testing.assert_close(got.cpu(), metrics_tpu_torch.functional.spearman_corrcoef(preds.cpu(), target.cpu()),
                               rtol=1e-6, atol=0)


def test_spearman_base_ranks_past_2_to_the_24_on_the_card(card):
    """``float32(i) + 1`` on the card is the CPU's (and ``jnp.arange(1, n + 1)``'s) bits at n = 2**24 + 4,096,
    and so are the ranks of that many distinct values (float64 data: no tie group to add in another order)."""
    from metrics_tpu_torch.functional.regression.spearman import _rank_data

    n = 2**24 + 4096
    assert torch.equal((torch.arange(n, dtype=torch.float32, device=card) + 1).cpu(),
                       torch.arange(n, dtype=torch.float32) + 1)
    data = torch.randn(n, generator=torch.Generator().manual_seed(55), dtype=torch.float64)
    assert torch.equal(_rank_data(data.to(card)).cpu(), _rank_data(data))


def test_regression_modules_on_the_card_equal_the_cpu(card):
    M = metrics_tpu_torch
    batches = _regression_batches(card, seed=56)

    def run(device):
        mods = {"mse": M.MeanSquaredError(device=device), "mae": M.MeanAbsoluteError(device=device),
                "msle": M.MeanSquaredLogError(device=device), "mape": M.MeanAbsolutePercentageError(device=device),
                "smape": M.SymmetricMeanAbsolutePercentageError(device=device),
                "wmape": M.WeightedMeanAbsolutePercentageError(device=device),
                "tweedie1": M.TweedieDevianceScore(power=1, device=device),
                "tweedie2": M.TweedieDevianceScore(power=2, device=device), "r2": M.R2Score(device=device),
                "ev": M.ExplainedVariance(device=device), "pearson": M.PearsonCorrCoef(device=device),
                "spearman": M.SpearmanCorrCoef(device=device), "cosine": M.CosineSimilarity(device=device)}
        for p, t in batches:
            for key, m in mods.items():
                if key == "cosine":
                    m.update(p.to(device).reshape(-1, 64), t.to(device).reshape(-1, 64))
                else:
                    m.update(p.to(device), t.to(device))
        return {k: m.compute().cpu() for k, m in mods.items()}

    cpu, gpu = run("cpu"), run(card)
    for key in cpu:
        torch.testing.assert_close(gpu[key], cpu[key], rtol=1e-6, atol=0, msg=key)


def test_pairwise_on_the_card_leaves_tf32_off_and_keeps_float32(card):
    """``allow_tf32`` reads False before and after; the linear similarity is
    within float32's dot-product bound of float64 (TF32's 10-bit mantissa
    would miss it by ~1e3), and the card's values equal the CPU's to the
    same bounds."""
    from metrics_tpu_torch.functional import pairwise_euclidean_distance, pairwise_linear_similarity

    assert torch.backends.cuda.matmul.allow_tf32 is False
    g = torch.Generator().manual_seed(57)
    x, y = torch.randn(256, 768, generator=g), torch.randn(512, 768, generator=g)
    got = pairwise_linear_similarity(x.to(card), y.to(card)).cpu()
    assert torch.backends.cuda.matmul.allow_tf32 is False
    ref = x.double() @ y.double().T
    bound = 768 * 2.0**-24 * x.norm(dim=1)[:, None].double() * y.norm(dim=1)[None].double()
    assert bool(((got.double() - ref).abs() <= bound).all())
    assert bool(((got - pairwise_linear_similarity(x, y)).abs().double() <= 2 * bound).all())
    d = pairwise_euclidean_distance(x.to(card)).cpu()
    assert torch.equal(torch.diagonal(d), torch.zeros(256))


def test_manhattan_row_blocks_on_the_card_are_bit_equal_to_one_block(card, monkeypatch):
    from metrics_tpu_torch.functional.pairwise import metrics as pairwise

    g = torch.Generator(device=card).manual_seed(58)
    x, y = torch.randn(100, 768, generator=g, device=card), torch.randn(300, 768, generator=g, device=card)
    whole = pairwise.pairwise_manhattan_distance(x, y)
    monkeypatch.setattr(pairwise, "MANHATTAN_BLOCK_BYTES", 7 * 300 * 768 * 4)
    assert pairwise.manhattan_block_rows(300, 768, 4) == 7
    assert torch.equal(pairwise.pairwise_manhattan_distance(x, y), whole)
    torch.testing.assert_close(whole.cpu(), pairwise.pairwise_manhattan_distance(x.cpu(), y.cpu()), rtol=1e-6, atol=0)


# ------------------------------------------------------- windows and wrappers
def _window(kind, card, engine):
    M = metrics_tpu_torch
    if kind == "accuracy":
        return M.SlidingWindow(M.Accuracy(num_classes=100, average="macro", device=card), window=6, slide=2,
                               jit_update=engine)
    if kind == "countmin":
        return M.SlidingWindow(M.CountMinHeavyHitters(width=4096, device=card), window=5, jit_update=engine)
    if kind == "foldtree":
        return M.FoldTreeWindow(M.HyperLogLog(precision=10, device=card), window=4, jit_update=engine)
    if kind == "ladder":
        return M.ResolutionLadder(M.QuantileSketch(device=card), levels=(3, 2, 2), jit_update=engine)
    if kind == "tumbling":
        return M.TumblingWindow(M.MeanMetric(device=card), window=3, jit_update=engine)
    return M.ExponentialDecay(M.Accuracy(num_classes=100, average="macro", device=card), halflife=4.0,
                              jit_update=engine)


def _window_batches(kind, card, n=14):
    rng = np.random.RandomState(60)
    if kind in ("accuracy", "decay"):
        return [_scores(rng, 512, 100, card) for _ in range(n)]
    if kind in ("countmin", "foldtree"):
        return [(torch.from_numpy(rng.zipf(1.2, 4096).clip(max=10**6).astype(np.float32)).to(card),) for _ in range(n)]
    return [(torch.from_numpy(rng.lognormal(0.0, 1.0, 1024).astype(np.float32)).to(card),) for _ in range(n)]


@pytest.mark.parametrize("kind", ["accuracy", "countmin", "foldtree", "ladder", "tumbling", "decay"])
def test_window_engine_ticks_replay_without_a_sync_and_equal_eager(card, kind):
    """Every tick of the engine (one graph replay, the refold and cascades as
    selects) bit-equal to the eager tick (the refold only on an advance), and
    a warm tick without a host sync."""
    engine, eager = _window(kind, card, True), _window(kind, card, False)
    for i, b in enumerate(_window_batches(kind, card)):
        if i < 1:
            engine.update(*b)  # the capture
        else:
            _no_sync(lambda b=b: engine.update(*b))
        eager.update(*b)
        for k in engine._defaults:
            assert torch.equal(getattr(engine, k), getattr(eager, k)), (kind, i, k)
    def same(a, b):  # bit for bit, NaN equal (an empty level's quantile)
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)

    same(engine.compute(), eager.compute())
    stats = engine.dispatch_stats
    assert stats["retraces"] == 1 and stats["demotions"] == 0 and not stats["permanent"]
    if kind == "foldtree":
        same(engine.compute_range(1, 4), eager.compute_range(1, 4))
    if kind == "ladder":
        for level in range(3):
            same(engine.compute_level(level), eager.compute_level(level))


def test_window_ticks_count_the_kernels_of_their_replays(card):
    w = _window("accuracy", card, True)
    reset_launches()
    for b in _window_batches("accuracy", card, n=9):
        w.update(*b)
    torch.cuda.synchronize()
    # the capture recorded the inner update's one stat_scores launch; each replay counts it again
    assert launches()["stat_scores"] == 9 and w.dispatch_stats["dispatches"] == 9


def test_fused_window_tick_is_one_graph_launch_a_tick(card, monkeypatch):
    from metrics_tpu_torch.ops import fused_window_tick

    replays = []
    original = torch.cuda.CUDAGraph.replay

    def counted(self):
        replays.append(self)
        return original(self)

    monkeypatch.setattr(torch.cuda.CUDAGraph, "replay", counted)
    fused, eager = _window("accuracy", card, False), _window("accuracy", card, False)
    batches = _window_batches("accuracy", card, n=10)
    reset_launches()
    for i, b in enumerate(batches):
        if i == 0:
            fused_window_tick(fused, b, {})  # the capture (its eager run serves the tick)
            assert not replays
        else:
            _no_sync(lambda b=b: fused_window_tick(fused, b, {}))
            assert len(replays) == i  # one graph launch this tick
        eager.update(*b)
        for k in fused._defaults:
            assert torch.equal(getattr(fused, k), getattr(eager, k)), (i, k)
    torch.cuda.synchronize()
    assert fused.dispatch_stats["dispatches"] == 10 and fused.dispatch_stats["retraces"] == 1
    # the eager window launched stat_scores itself 10 times, the fused tick's graph once a replay
    assert launches()["stat_scores"] == 10 + 9 + 1


def _wrapper_runs(device):
    M = metrics_tpu_torch
    rng = np.random.RandomState(61)
    batches = [(torch.from_numpy(rng.rand(256, 50).astype(np.float32)).to(device),
                torch.from_numpy(rng.randint(0, 50, 256).astype(np.int32)).to(device)) for _ in range(4)]
    reg = [(torch.from_numpy(rng.randn(256, 3).astype(np.float32)).to(device),
            torch.from_numpy(rng.randn(256, 3).astype(np.float32)).to(device)) for _ in range(4)]
    reg[1][0][::7, 1] = float("nan")
    boot = M.BootStrapper(M.Accuracy(num_classes=50, average="macro", device=device), num_bootstraps=5,
                          quantile=torch.tensor([0.1, 0.9]).to(device), raw=True)
    boot._rng = np.random.RandomState(3)
    classwise = M.ClasswiseWrapper(M.Accuracy(num_classes=50, average=None, device=device))
    minmax = M.MinMaxMetric(M.Accuracy(num_classes=50, average="macro", device=device))
    multi = M.MultioutputWrapper(M.R2Score(device=device), 3)
    tracker = M.MetricTracker(M.Accuracy(num_classes=50, average="macro", jit_update=True, device=device))
    out = {"minmax": []}
    for i, (p, t) in enumerate(batches):
        boot.update(p, t)
        classwise.update(p, t)
        minmax.update(p, t)
        out["minmax"].append(minmax.compute())
        tracker.increment()
        tracker.update(p, t)
        multi.update(*reg[i])
    out.update(boot=boot.compute(), classwise=classwise.compute(), multi=multi.compute(),
               tracker=tracker.compute_all(), best=tracker.best_metric(return_step=True))
    out["copies"] = [{k: getattr(m, k) for k in m._defaults} for m in boot.metrics]
    return out


def test_wrappers_on_the_card_equal_the_cpu(card):
    got, want = _wrapper_runs(card), _wrapper_runs(torch.device("cpu"))

    def close(a, b, what):
        if isinstance(b, dict):
            assert list(a) == list(b), what
            for k in b:
                close(a[k], b[k], f"{what}.{k}")
        elif isinstance(b, (list, tuple)):
            for i, (x, y) in enumerate(zip(a, b)):
                close(x, y, f"{what}[{i}]")
        elif isinstance(b, torch.Tensor):
            assert a.device.type == "cuda", what
            if b.is_floating_point():
                torch.testing.assert_close(a.cpu(), b, rtol=1e-6, atol=0, equal_nan=True, msg=what)
            else:
                assert torch.equal(a.cpu(), b), what  # the resampled copies' counts: bit for bit
        else:
            assert (a == b) if not isinstance(b, float) else np.isclose(a, b, rtol=1e-6), what

    close(got, want, "wrappers")


def test_tracker_steps_on_the_card_keep_their_own_graphs(card):
    """A step copied from a base whose engine captured graphs holds none of
    them: its updates replay graphs of its own, and the base's and earlier
    steps' states stay as they were."""
    M = metrics_tpu_torch
    rng = np.random.RandomState(62)
    base = M.MetricCollection([M.Accuracy(num_classes=100, average="macro", device=card),
                               M.Precision(num_classes=100, average="macro", device=card)], fused_update=True)
    p, t = _scores(rng, 512, 100, card)
    base.update(p, t)
    base.update(p, t)
    tracker = M.MetricTracker(base)
    before = {k: v.clone() for k, v in base.compute().items()}
    values = []
    for _ in range(3):
        tracker.increment()
        q, u = _scores(rng, 512, 100, card)
        for _ in range(3):
            tracker.update(q, u)
        values.append({k: v.clone() for k, v in tracker.compute().items()})
        assert tracker[-1]._dispatcher is not base._dispatcher
    for i, v in enumerate(values):
        for k in v:
            assert torch.equal(tracker[i].compute()[k], v[k]), (i, k)
    for k, v in base.compute().items():
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("name", ["MeanMetric", "SumMetric", "MaxMetric", "MinMetric"])
def test_aggregator_engines_capture_a_number_argument(card, name):
    """``MeanMetric``'s default ``weight=1.0`` (and any number given to an
    aggregator) becomes a device fill inside the program, not a copy from the
    host, which a CUDA graph cannot capture: the engine never demotes."""
    rng = np.random.RandomState(63)
    engine = getattr(metrics_tpu_torch, name)(jit_update=True, device=card)
    eager = getattr(metrics_tpu_torch, name)(device=card)
    for i in range(5):
        x = torch.from_numpy(rng.randn(64).astype(np.float32)).to(card)
        if i < 1:
            engine.update(x)
        else:
            _no_sync(lambda x=x: engine.update(x))
        eager.update(x)
    assert engine.dispatch_stats["demotions"] == 0 and engine.dispatch_stats["retraces"] == 1
    for k in engine._defaults:
        assert torch.equal(getattr(engine, k), getattr(eager, k)), k


# ------------------------------------------------------------------ observability
def test_a_warm_instrumented_engine_update_makes_no_host_sync(card):
    from metrics_tpu_torch import telemetry

    rng = np.random.RandomState(70)
    m = metrics_tpu_torch.Accuracy(num_classes=1000, average="macro", jit_update=True, device=card)
    m.update(*_scores(rng, 1024, 1000, card))
    with telemetry.instrument() as session:
        for _ in range(3):
            b = _scores(rng, 1024, 1000, card)
            _no_sync(lambda b=b: m.update(*b))
    updates = session.spans(name="update")
    assert len(updates) == 3 and all(e.kind == "aot" and e.attrs["roofline_basis"] == "absolute" for e in updates)
    assert all(isinstance(v, (bool, int, float, str, type(None))) for e in updates for v in e.attrs.values())


def test_a_kernel_event_fires_for_each_eager_launch_and_none_for_a_replay(card):
    from metrics_tpu_torch import telemetry

    rng = np.random.RandomState(71)
    eager = metrics_tpu_torch.Accuracy(num_classes=100, average="macro", device=card)
    engine = metrics_tpu_torch.Accuracy(num_classes=100, average="macro", jit_update=True, device=card)
    batches = [_scores(rng, 512, 100, card) for _ in range(4)]
    reset_launches()
    registry.reset_stats()  # an earlier test may have launched at this shape: first= counts from here
    with telemetry.instrument() as session:
        for b in batches:
            eager.update(*b)
            engine.update(*b)
    torch.cuda.synchronize()
    events = session.spans(name="kernel", owner="ops.stat_scores")
    # four eager launches, and the engine's one build (its warm-up run); its three replays fire none
    assert launches()["stat_scores"] == 8 and registry.replayed_launches()["stat_scores"] == 3
    assert len(events) == 5 and session.count(name="compile") == 1
    assert [e.attrs["first"] for e in events] == [True] + [False] * 4
    assert all(e.attrs["model_bytes"] == 13.0 * 512 + 12.0 * 100 for e in events)


def test_device_peaks_resolve_the_cards_row(card):
    from metrics_tpu_torch.analysis import billing, cost_model

    name = torch.cuda.get_device_name(card)
    want = "H100" if "H100" in name else "cuda"
    assert cost_model.device_peaks(refresh=True) == cost_model.DEVICE_PEAKS[want]
    assert billing.device_rate(refresh=True) == (want, billing.DEVICE_RATES[want])


def test_each_kernels_entry_is_its_bound_terms(card):
    """A launch's cost entry holds the terms of ``chip_smoke.py``'s bound (PERF.md's bound column): the bytes
    the kernel must move and its operations (stat_scores: at most three adds a row)."""
    import math

    from metrics_tpu_torch import telemetry
    from metrics_tpu_torch.ops.sketch_ops import _countmin_kernel

    rng = np.random.RandomState(72)
    n, c, t, q, l, depth, width = 1024, 1000, 100, 64, 1000, 4, 1024
    preds, target = _scores(rng, n, c, card)
    pred_cls = preds.argmax(dim=1).to(torch.int32)
    y = torch.from_numpy(rng.randint(0, 2, (n, c)).astype(bool)).to(card)
    thr = torch.linspace(0, 1, t, device=card)
    sp = torch.from_numpy(rng.rand(q, l).astype(np.float32)).to(card)
    st = torch.from_numpy(rng.randint(0, 2, (q, l)).astype(np.int32)).to(card)
    keys = torch.from_numpy(rng.randint(0, 2**31, n).astype(np.int32)).to(card)
    calls = {
        "ops.stat_scores": (lambda: stat_scores_counts(target, pred_cls, pred_cls == target,
                                                       torch.ones(n, dtype=torch.int32, device=card), c),
                            13.0 * n + 12.0 * c, 3.0 * n),
        "ops.confusion_matrix": (lambda: confusion_matrix_counts(target, pred_cls, c), 8.0 * n + 4.0 * c * c, n),
        "ops.binned_stats": (lambda: binned_stat_scores(preds, y, thr), 5.0 * n * c + 12.0 * c * t,
                             n * c * (math.ceil(math.log2(t + 1)) + 1) + c * t),
        "ops.retrieval_sort": (lambda: sorted_by_preds(sp, st), 12.0 * q * l, q * l * math.ceil(math.log2(l))),
        "ops.countmin_scatter": (lambda: _countmin_kernel(torch.zeros(depth, width, device=card), keys,
                                                         torch.ones(n, device=card),
                                                         torch.arange(depth, dtype=torch.int32, device=card)),
                                 8.0 * n + 4.0 * depth + 8.0 * depth * width, 11.0 * n * depth),
    }
    for owner, (call, nbytes, ops) in calls.items():
        with telemetry.instrument() as session:
            call()
        (event,) = session.spans(name="kernel")
        assert event.owner == owner
        assert (event.attrs["model_bytes"], event.attrs["model_flops"]) == (nbytes, float(ops)), owner


def _sync_count(fn):
    """The host<->device synchronisations of one call of ``fn``, from PyTorch's sync debug mode."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def test_an_idle_stream_adds_no_host_sync_to_an_eager_window(card, monkeypatch):
    """With telemetry on and no session, an eager tumbling tick and a sliding read make the host syncs they make
    with telemetry off; a session adds one each (whether the tick advanced, the read's live count)."""
    from metrics_tpu_torch import telemetry

    rng = np.random.RandomState(73)
    tumbling, sliding = _window("tumbling", card, False), _window("accuracy", card, False)
    values = [(torch.from_numpy(rng.lognormal(0.0, 1.0, 1024).astype(np.float32)).to(card),) for _ in range(3)]
    for b in _window_batches("accuracy", card, n=3):
        sliding.update(*b)
    calls = {"tumbling": (lambda: tumbling.update(*values[0])), "sliding": sliding._compute_impl}
    for name, call in calls.items():
        call()  # warm
        monkeypatch.setenv("METRICS_TPU_TELEMETRY", "0")
        off = _sync_count(call)
        monkeypatch.delenv("METRICS_TPU_TELEMETRY")
        idle = _sync_count(call)
        with telemetry.instrument():
            instrumented = _sync_count(call)
        assert idle == off and instrumented == off + 1, (name, off, idle, instrumented)


# ------------------------------------------------- the service (serve.py) and the stat_scores session axis
@pytest.mark.parametrize("sessions,n,c", [(1, 1, 2), (7, 64, 1000), (1024, 64, 1000), (64, 32, 20000), (3, 0, 10)])
def test_stat_scores_session_axis_equals_plain(card, sessions, n, c):
    from metrics_tpu_torch.ops import stat_scores_counts_sessions
    from metrics_tpu_torch.ops.stat_scores import _stat_counts_sessions_plain, stat_scores_sessions_branch

    rng = np.random.RandomState(sessions + n + c)
    target = torch.from_numpy(rng.randint(-3 * c - 2, 3 * c + 2, (sessions, n)).astype(np.int32)).to(card)
    pred = torch.from_numpy(rng.randint(-3 * c - 2, 3 * c + 2, (sessions, n)).astype(np.int32)).to(card)
    w = torch.from_numpy(rng.randint(0, 2, (sessions, n)).astype(np.int32)).to(card)
    correct = (pred == target) & (w > 0)
    reset_launches()
    got = stat_scores_counts_sessions(target, pred, correct, w, c)
    torch.cuda.synchronize()
    branch = stat_scores_sessions_branch(sessions, n, c, card)
    assert branch == ("sessions-global" if c == 20000 else "sessions")
    assert launches()["stat_scores"] == 1
    assert registry.launches_by_shape("stat_scores") == {(branch, (sessions, n, c)): 1}
    assert got.dtype == torch.int32 and torch.equal(got, _stat_counts_sessions_plain(target, pred, correct, w, c))


def _service_batches(card, tenants, flushes, rows=32, c=100, seed=80):
    g = torch.Generator(device=card).manual_seed(seed)
    out = []
    for _ in range(flushes):
        target = torch.randint(0, c, (tenants, rows), generator=g, device=card)
        preds = torch.rand(tenants, rows, c, generator=g, device=card)
        preds[torch.arange(tenants, device=card)[:, None], torch.arange(rows, device=card)[None, :], target] += 0.5
        out.append([(preds[i], target[i]) for i in range(tenants)])
    return out


def test_service_stacked_replays_equal_dedicated_eager_metrics(card):
    from metrics_tpu_torch import Accuracy
    from metrics_tpu_torch.serve import MetricsService

    svc = MetricsService(Accuracy(num_classes=100, average="macro", device=card))
    refs = [Accuracy(num_classes=100, average="macro", device=card) for _ in range(20)]
    batches = _service_batches(card, 20, 3)
    reset_launches()
    for flush in batches:
        for i, (p, t) in enumerate(flush):
            svc.submit(f"t{i}", p, t)
        svc.flush()
    svc.drain()
    torch.cuda.synchronize()
    counted, replayed = launches()["stat_scores"], registry.replayed_launches()["stat_scores"]
    # one session-axis launch a flush: the first flush's warm-up run, then two graph replays
    assert svc.stats["launches"] == counted == 3 and replayed == 2 and svc.stats["fallback_requests"] == 0
    assert registry.launches_by_shape("stat_scores") == {("sessions", (32, 32, 100)): 3}
    for flush in batches:
        for ref, (p, t) in zip(refs, flush):
            ref.update(p, t)
    values = svc.compute_all()
    for i, ref in enumerate(refs):
        assert torch.equal(values[f"t{i}"], ref.compute())
        assert torch.equal(svc.compute(f"t{i}"), ref.compute())
    tickets = [svc.submit(f"t{i}", p, t, return_value=True) for i, (p, t) in enumerate(batches[0])]
    svc.drain()
    for ticket, (p, t) in zip(tickets, batches[0]):
        fresh = Accuracy(num_classes=100, average="macro", device=card)
        fresh.update(p, t)
        assert torch.equal(ticket.result(timeout=30), fresh.compute())


def test_service_pad_lanes_write_only_the_scratch_row_on_the_card(card):
    from metrics_tpu_torch import Accuracy
    from metrics_tpu_torch.serve import MetricsService

    svc = MetricsService(Accuracy(num_classes=100, average="macro", device=card))
    for i in range(64):
        svc.open_session(f"s{i}")
    before = {k: v.clone() for k, v in svc._stacked.items()}
    fed = ["s63", "s62", "s0"]
    for flush in _service_batches(card, 3, 2):
        for name, (p, t) in zip(fed, flush):
            svc.submit(name, p, t)
        svc.flush()
    svc.drain()
    torch.cuda.synchronize()  # an index past the buffer would have asserted on the device
    touched = {svc._rows[n] for n in fed}
    for k, leaf in svc._stacked.items():
        same = (leaf == before[k]).reshape(64, -1).all(dim=1).cpu().tolist()
        assert [not s for s in same] == [r in touched for r in range(64)], k
    assert svc.stats["launches"] == 2 and svc.stats["fallback_requests"] == 0


def test_first_capture_while_threads_submit(card):
    """The flush worker captures the first graph while eight threads submit:
    the capture (thread-local mode) stands, and every session ends as the
    same stream served on the CPU."""
    import threading

    from metrics_tpu_torch import Accuracy
    from metrics_tpu_torch.serve import MetricsService

    svc = MetricsService(Accuracy(num_classes=100, average="macro", device=card), flush_interval_s=0.002)
    cpu = MetricsService(Accuracy(num_classes=100, average="macro", device="cpu"))
    batches = _service_batches(card, 8, 20, seed=81)
    errors = []

    def submitter(i):
        try:
            for flush in batches:
                svc.submit(f"t{i}", *flush[i])
        except Exception as err:  # noqa: BLE001 - surfaced below
            errors.append(err)

    with metrics_tpu_torch.telemetry.instrument() as session:
        threads = [threading.Thread(target=submitter, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        svc.shutdown()
    assert not errors and not any(t.is_alive() for t in threads)
    assert not session.spans(name="degrade"), [e.attrs for e in session.spans(name="degrade")]
    assert svc.stats["fallback_requests"] == 0 and svc.stats["submits"] == 160
    assert any(p.graph is not None for p in svc._exec_cache.values())
    for flush in batches:
        for i in range(8):
            cpu.submit(f"t{i}", *(x.cpu() for x in flush[i]))
    cpu.drain()
    assert svc.state_digest() == cpu.state_digest()


def test_a_failed_capture_benches_the_stacked_path(card, monkeypatch):
    """A capture that fails after the warm-up run has served its flush: the
    program goes, one ``degrade`` of kind ``serve`` benches the stacked path,
    the cooldown's flushes take the per-request eager fallback, and the next
    stacked flush captures anew; every session ends as dedicated metrics."""
    from metrics_tpu_torch import Accuracy
    from metrics_tpu_torch.serve import MetricsService

    svc = MetricsService(Accuracy(num_classes=100, average="macro", device=card))
    refs = [Accuracy(num_classes=100, average="macro", device=card) for _ in range(4)]
    capture, calls = svc._capture, []

    def refused_once(program, run):
        calls.append(program)
        if len(calls) == 1:
            raise RuntimeError("capture refused")
        return capture(program, run)

    monkeypatch.setattr(svc, "_capture", refused_once)
    batches = _service_batches(card, 4, 8, seed=82)
    with metrics_tpu_torch.telemetry.instrument() as session:
        for flush in batches:
            for i, (p, t) in enumerate(flush):
                svc.submit(f"t{i}", p, t)
            svc.flush()
        svc.drain()
    degrades = session.spans(name="degrade")
    assert [e.kind for e in degrades] == ["serve"] and len(calls) == 2
    cooldown = degrades[0].attrs["cooldown"]
    assert 0 < cooldown < len(batches) - 1
    assert svc.stats["launches"] == len(batches) - cooldown and svc.stats["fallback_requests"] == 4 * cooldown
    assert calls[0] not in svc._exec_cache.values() and calls[1].graph is not None
    for flush in batches:
        for ref, (p, t) in zip(refs, flush):
            ref.update(p, t)
    values = svc.compute_all()
    for i, ref in enumerate(refs):
        assert torch.equal(values[f"t{i}"], ref.compute())


# ------------------------------------------------------------------ slice 15: countmin's session axis, the fabric
@pytest.mark.parametrize("sessions,n,depth,width,integral", [
    (1, 1, 1, 1, True), (7, 37, 4, 1000, True), (256, 4096, 4, 1024, True), (3, 0, 4, 64, True),
    (5, 100, 8, 1023, True), (4, 65536, 4, 65536, True), (16, 4096, 4, 1024, False), (4, 4096, 4, 65536, False),
])
def test_countmin_session_axis_equals_plain(card, sessions, n, depth, width, integral):
    from metrics_tpu_torch.ops import countmin_update_sessions
    from metrics_tpu_torch.ops.sketch_ops import _countmin_sessions_plain, countmin_sessions_branch

    g = torch.Generator(device=card).manual_seed(sessions * 7 + n)
    values = torch.randint(0, 5, (sessions, depth, width), generator=g, device=card).float()
    keys = torch.randint(0, 3000, (sessions, n), generator=g, device=card).float()
    bits = keys.view(torch.int32)
    w = (torch.randint(0, 3, (sessions, n), generator=g, device=card).float() if integral
         else torch.rand(sessions, n, generator=g, device=card))
    seeds = (torch.arange(depth, device=card, dtype=torch.int64) * 0x9E3779B9 + 1) & 0xFFFFFFFF
    seeds = torch.where(seeds >= 2**31, seeds - 2**32, seeds).to(torch.int32)
    reset_launches()
    got = countmin_update_sessions(values, bits, w, seeds)
    torch.cuda.synchronize()
    branch = countmin_sessions_branch(sessions, n, depth, width, card)
    assert launches()["countmin"] == 1
    assert registry.launches_by_shape("countmin") == {(branch, (sessions, n, depth, width)): 1}
    ref = _countmin_sessions_plain(values, bits, w, seeds)
    if integral:
        assert torch.equal(got, ref)
    else:  # fractional weights summed in another order
        torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-5)
    if branch == "sessions":  # no atomics: the same bits every call
        assert torch.equal(countmin_update_sessions(values, bits, w, seeds), got)


def test_countmin_service_is_one_session_axis_launch_a_flush(card):
    from metrics_tpu_torch import CountMinHeavyHitters
    from metrics_tpu_torch.serve import MetricsService

    svc = MetricsService(CountMinHeavyHitters(depth=4, width=1024, device=card))
    refs = [CountMinHeavyHitters(depth=4, width=1024, device=card) for _ in range(24)]
    g = torch.Generator(device=card).manual_seed(90)
    reset_launches()
    flushes = [torch.randint(0, 5000, (24, 512), generator=g, device=card).float() for _ in range(3)]
    for ids in flushes:
        for i in range(24):
            svc.submit(f"a{i}", ids[i])
        svc.drain()
    torch.cuda.synchronize()
    assert launches()["countmin"] == 3 and registry.replayed_launches()["countmin"] == 2
    assert registry.launches_by_shape("countmin") == {("sessions", (32, 512, 4, 1024)): 3}
    assert svc.stats["launches"] == 3 and svc.stats["fallback_requests"] == 0
    for ids in flushes:
        for i, ref in enumerate(refs):
            ref.update(ids[i])
    for i, ref in enumerate(refs):
        assert torch.equal(svc._stacked["value"][svc._rows[f"a{i}"]], ref.value)


def _fleet_names(fab, per_shard):
    """Session names that fill every shard of ``fab`` with ``per_shard`` sessions."""
    names, counts, i = [], {s.shard_id: 0 for s in fab._shards}, 0
    while min(counts.values()) < per_shard:
        name, i = f"t{i}", i + 1
        k = fab.shard_for(name)
        if counts[k] < per_shard:
            counts[k] += 1
            names.append(name)
    return names


def test_four_shards_capture_concurrently_and_serve_the_cpus_values(card, tmp_path):
    """The fleet read flushes the four shards on its thread pool: their first
    captures run at once. Every capture stands, nothing degrades, and the
    fleet equals the same stream on a CPU fabric."""
    from metrics_tpu_torch import Accuracy, resilience
    from metrics_tpu_torch.fabric import ShardedMetricsService

    fab = ShardedMetricsService(Accuracy(num_classes=100, average="macro", device=card), num_shards=4,
                                data_dir=str(tmp_path / "card"))
    cpu = ShardedMetricsService(Accuracy(num_classes=100, average="macro", device="cpu"), num_shards=4)
    names = _fleet_names(fab, 16)
    degrades = sum(resilience.degrades().values())
    batches = _service_batches(card, len(names), 3, seed=91)
    with metrics_tpu_torch.telemetry.instrument() as session:
        for flush in batches:
            for name, (p, t) in zip(names, flush):
                fab.submit(name, p, t)
                cpu.submit(name, p.cpu(), t.cpu())
            values = fab.compute_all()
    torch.cuda.synchronize()
    assert sum(resilience.degrades().values()) == degrades and not session.spans(name="degrade")
    for s in fab._shards:
        assert s.service.stats["launches"] == 3 and s.service.stats["fallback_requests"] == 0
        assert any(p.graph is not None for p in s.service._exec_cache.values())
    # the counts bit for bit; the macro mean of the card's values to float32 rounding of the CPU's
    want = cpu.compute_all()
    assert [s.service.state_digest() for s in fab._shards] == [s.service.state_digest() for s in cpu._shards]
    for n in names:
        torch.testing.assert_close(values[n].cpu(), want[n], rtol=1e-6, atol=0)


def test_fleet_read_replays_one_graph_and_drops_it_when_rows_move(card, tmp_path):
    """A warm fleet read is one graph replay with no ``fleet-read`` degrade; a
    rebalance (and a failover) move rows to new buffers, and the graph that
    read the old ones is gone: the next read captures anew and equals an
    unmoved twin's values."""
    from metrics_tpu_torch import Accuracy, resilience
    from metrics_tpu_torch.fabric import ShardedMetricsService

    make = lambda: Accuracy(num_classes=100, average="macro", device=card)  # noqa: E731
    fab = ShardedMetricsService(make(), num_shards=3, data_dir=str(tmp_path / "fab"))
    twin = ShardedMetricsService(make(), num_shards=3)
    names = _fleet_names(fab, 8)
    batches = _service_batches(card, len(names), 2, seed=92)
    for flush in batches:
        for name, (p, t) in zip(names, flush):
            fab.submit(name, p, t)
            twin.submit(name, p, t)
    before = resilience.degrades().get("fleet-read", 0)
    with metrics_tpu_torch.telemetry.instrument() as session:
        first = fab.compute_all()
        for name, (p, t) in zip(names, batches[0]):
            fab.submit(name, p, t)
            twin.submit(name, p, t)
        replay = torch.cuda.CUDAGraph.replay
        replays = []
        try:
            torch.cuda.CUDAGraph.replay = lambda self: (replays.append(self), replay(self))[1]
            warm = fab.compute_all()
        finally:
            torch.cuda.CUDAGraph.replay = replay
    assert len(session.spans(name="compile", kind="fleet-read")) == 1
    (program,) = fab._fleet_programs.values()
    assert program.graph in replays and resilience.degrades().get("fleet-read", 0) == before
    want = twin.compute_all()
    assert all(torch.equal(warm[n], want[n]) for n in names) and set(first) == set(names)
    stale = set(fab._fleet_programs)
    fab.add_shard()
    fab.rebalance()
    assert fab._fleet_programs == {}
    moved = fab.compute_all()
    assert all(torch.equal(moved[n], want[n]) for n in names) and not stale & set(fab._fleet_programs)
    fab.kill_shard(0)
    fab.fail_over(0)
    assert fab._fleet_programs == {}
    after = fab.compute_all()
    assert all(torch.equal(after[n], want[n]) for n in names)
    assert resilience.degrades().get("fleet-read", 0) == before
    rolled, want_rolled = fab.rollup(), twin.rollup()
    assert torch.equal(rolled, want_rolled)


def test_a_capacity_doubling_drops_the_fleet_graph_of_the_old_buffers(card):
    """A shard that outgrows its rows reallocates its buffers: the fleet graph
    captured on the old ones can never replay again, and its next build drops
    it (with its graph's memory) instead of keeping it beside the new one."""
    from metrics_tpu_torch import Accuracy
    from metrics_tpu_torch.fabric import ShardedMetricsService

    make = lambda: Accuracy(num_classes=100, average="macro", device=card)  # noqa: E731
    fab, twin = ShardedMetricsService(make(), num_shards=2), ShardedMetricsService(make(), num_shards=2)
    few, many = _fleet_names(fab, 8), _fleet_names(fab, 100)  # 100 rows a shard: past 64, the buffers double
    for group, seed in ((few, 93), (many, 94)):
        for name, (p, t) in zip(group, _service_batches(card, len(group), 1, seed=seed)[0]):
            fab.submit(name, p, t)
            twin.submit(name, p, t)
        fab.compute_all()
        fab.rollup()
        if group is few:
            old = {k: p.graph for k, p in fab._fleet_programs.items()}
            assert len(old) == 2 and all(g is not None for g in old.values())
    assert len(fab._fleet_programs) == 2 and not set(old) & set(fab._fleet_programs)
    got, want = fab.compute_all(), twin.compute_all()
    assert sorted(got) == sorted(many) and all(torch.equal(got[n], want[n]) for n in many)
    fab.shutdown()
    twin.shutdown()


# ------------------------------------------------------------ image metrics
def _card_images(card, shape, seed):
    """A smooth target in [0, 1] (a coarse random grid, upsampled) and a noisy
    prediction near 30 dB, clipped: textured enough that no window is flat."""
    g = torch.Generator(device=card).manual_seed(seed)
    coarse = torch.rand(*shape[:2], *(max(2, n // 8) for n in shape[2:]), generator=g, device=card)
    mode = "bilinear" if len(shape) == 4 else "trilinear"
    field = torch.nn.functional.interpolate(coarse, size=shape[2:], mode=mode, align_corners=True)
    target = 0.5 * field + 0.5 * torch.rand(*shape, generator=g, device=card)
    preds = (target + 0.0316 * torch.randn(*shape, generator=g, device=card)).clamp(0, 1)
    return preds, target


IMAGE_MODULES = {
    "PeakSignalNoiseRatio": {},
    "StructuralSimilarityIndexMeasure": {},
    "MultiScaleStructuralSimilarityIndexMeasure": {"kernel_size": 5, "sigma": 0.5, "betas": (0.3, 0.4, 0.3)},
    "UniversalImageQualityIndex": {},
    "ErrorRelativeGlobalDimensionlessSynthesis": {},
    "SpectralAngleMapper": {},
    "SpectralDistortionIndex": {},
}


@pytest.mark.parametrize("cls", sorted(IMAGE_MODULES))
def test_image_metrics_live_on_the_card_and_equal_the_cpu(card, cls):
    """No ``device``: the states are on the card, and the value equals the
    same module on the CPU (windowed values atol 1e-5, the rest rtol 1e-5;
    D-lambda also atol 1e-6)."""
    kwargs = IMAGE_MODULES[cls]
    m, ref = getattr(metrics_tpu_torch, cls)(**kwargs), getattr(metrics_tpu_torch, cls)(**kwargs, device="cpu")
    for seed in (60, 61):
        p, t = _card_images(card, (2, 4, 48, 48), seed)
        m.update(p, t)
        ref.update(p.cpu(), t.cpu())
    for key in m._defaults:
        value = getattr(m, key)
        assert all(v.device.type == "cuda" for v in (value if isinstance(value, list) else [value])), key
    got = m.compute()
    assert got.device.type == "cuda"
    tol = {"atol": 1e-5, "rtol": 0} if cls in ("StructuralSimilarityIndexMeasure", "UniversalImageQualityIndex",
                                               "MultiScaleStructuralSimilarityIndexMeasure") else {"rtol": 1e-5,
                                                                                                  "atol": 1e-6}
    if cls == "SpectralAngleMapper":
        tol = {"atol": 1e-3, "rtol": 0}
    torch.testing.assert_close(got.cpu(), ref.compute(), **tol)


def test_ssim_is_tf32_free_under_default_flags_and_restores_them(card):
    """cuDNN runs float32 convolutions in TF32 unless told otherwise: SSIM's
    value under the default flag (on) equals the value with the flag off, bit
    for bit, and the caller's flag reads as it was after each call."""
    from metrics_tpu_torch.functional import structural_similarity_index_measure, universal_image_quality_index

    p, t = _card_images(card, (2, 3, 128, 128), 62)
    before = torch.backends.cudnn.allow_tf32
    try:
        values = {}
        for flag in (True, False):
            torch.backends.cudnn.allow_tf32 = flag
            values[flag] = (structural_similarity_index_measure(p, t, reduction="none"),
                            universal_image_quality_index(p, t, reduction="none"))
            assert torch.backends.cudnn.allow_tf32 is flag
    finally:
        torch.backends.cudnn.allow_tf32 = before
    for on, off in zip(values[True], values[False]):
        assert torch.equal(on, off)
    cpu = structural_similarity_index_measure(p.cpu(), t.cpu(), reduction="none")
    torch.testing.assert_close(values[True][0].cpu(), cpu, atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", ["psnr", "psnr range", "psnr dim", "ssim", "ms-ssim", "d-lambda"])
def test_image_update_and_compute_make_no_host_sync(card, case):
    M = metrics_tpu_torch
    make, shape = {
        "psnr": (lambda: M.PeakSignalNoiseRatio(), (2, 3, 64, 64)),
        "psnr range": (lambda: M.PeakSignalNoiseRatio(data_range=1.0), (2, 3, 64, 64)),
        "psnr dim": (lambda: M.PeakSignalNoiseRatio(data_range=1.0, dim=(1, 2, 3), reduction="none"),
                     (2, 3, 64, 64)),
        "ssim": (lambda: M.StructuralSimilarityIndexMeasure(), (2, 3, 64, 64)),
        "ms-ssim": (lambda: M.MultiScaleStructuralSimilarityIndexMeasure(kernel_size=5, sigma=0.5,
                                                                         betas=(0.3, 0.4, 0.3)), (2, 3, 64, 64)),
        "d-lambda": (lambda: M.SpectralDistortionIndex(), (2, 8, 48, 48)),
    }[case]
    m, ref = make(), make()
    batches = [_card_images(card, shape, seed) for seed in (63, 64)]
    m.update(*batches[0])
    m.compute()  # warm: the first call of an operation may read the device while it sets up
    _no_sync(lambda: m.update(*batches[1]))
    value = []
    _no_sync(lambda: value.append(m.compute()))
    for b in batches:
        ref.update(*b)
    assert torch.equal(value[0], ref.compute())


def test_psnr_engine_captures_and_replays_bit_equal_to_eager(card):
    """``PeakSignalNoiseRatio(jit_update=True)``: one captured program (two
    graphs), every later update a replay without a host sync, the states and
    value bit-equal to the eager update's, an int64 count."""
    M = metrics_tpu_torch
    engine, eager = M.PeakSignalNoiseRatio(jit_update=True), M.PeakSignalNoiseRatio()
    batches = [_card_images(card, (4, 3, 64, 96), seed) for seed in range(65, 70)]
    engine.update(*batches[0])
    for b in batches[1:]:
        _no_sync(lambda b=b: engine.update(*b))
    for b in batches:
        eager.update(*b)
    programs = list(engine._dispatcher._cache.values())
    assert len(programs) == 1 and len(programs[0].graphs) == 2
    for key in eager._defaults:
        assert torch.equal(getattr(engine, key), getattr(eager, key)), key
    assert engine.total.dtype == torch.int64 and int(engine.total) == 5 * 4 * 3 * 64 * 96
    assert torch.equal(engine.compute(), eager.compute())
    stats = engine.dispatch_stats
    assert stats["dispatches"] == 5 and stats["retraces"] == 1 and stats["demotions"] == 0


# ------------------------------------------------------------ audio metrics
def _card_speech(card, shape, seed, noise=0.2):
    """Seeded sources on the card (white noise under a 4 Hz envelope with a
    silent gap) and estimates: each source plus noise."""
    g = torch.Generator(device=card).manual_seed(seed)
    n = shape[-1]
    t = torch.arange(n, device=card, dtype=torch.float32)
    envelope = (0.3 + 0.7 * torch.sin(2 * np.pi * 4 * t / 8000).abs())
    envelope[n // 3: n // 3 + n // 8] = 0.0
    target = torch.randn(*shape, generator=g, device=card) * envelope
    preds = target + noise * torch.randn(*shape, generator=g, device=card)
    return preds, target


AUDIO_MODULES = {
    "SignalNoiseRatio": ({}, (4, 8000)),
    "ScaleInvariantSignalNoiseRatio": ({}, (4, 8000)),
    "SignalDistortionRatio": ({}, (4, 8000)),
    "ScaleInvariantSignalDistortionRatio": ({}, (4, 8000)),
    "PermutationInvariantTraining": ({"metric_func": "scale_invariant_signal_distortion_ratio"}, (4, 3, 8000)),
    "ShortTimeObjectiveIntelligibility": ({"fs": 16000, "extended": False}, (4, 24000)),
    "PerceptualEvaluationSpeechQuality": ({"fs": 16000, "mode": "wb", "backend": "native"}, (2, 32000)),
}


def _audio_module(cls, **extra):
    kwargs = dict(AUDIO_MODULES[cls][0])
    if "metric_func" in kwargs:
        kwargs["metric_func"] = getattr(metrics_tpu_torch.functional, kwargs["metric_func"])
    return getattr(metrics_tpu_torch, cls)(**kwargs, **extra)


@pytest.mark.parametrize("cls", sorted(AUDIO_MODULES))
def test_audio_metrics_live_on_the_card_and_equal_the_cpu(card, cls):
    """No ``device``: the states are on the card, and the value equals the same
    module on the CPU (rtol 1e-5; SDR 1e-4 dB near 10 dB, the float32 solve's
    tolerance; PESQ exact, one numpy core)."""
    m, ref = _audio_module(cls), _audio_module(cls, device="cpu")
    for seed in (70, 71):
        p, t = _card_speech(card, AUDIO_MODULES[cls][1], seed)
        m.update(p, t)
        ref.update(p.cpu(), t.cpu())
    assert all(getattr(m, key).device.type == "cuda" for key in m._defaults)
    assert m.total.dtype == torch.int32 and torch.equal(m.total.cpu(), ref.total)
    got = m.compute()
    assert got.device.type == "cuda"
    tol = {"atol": 0, "rtol": 0} if cls == "PerceptualEvaluationSpeechQuality" else {"atol": 1e-4, "rtol": 1e-5}
    torch.testing.assert_close(got.cpu(), ref.compute(), **tol)


@pytest.mark.parametrize("case", ["snr", "si-sdr", "sdr", "stoi", "stoi extended", "pit 2", "pit 3"])
def test_audio_update_and_compute_make_no_host_sync(card, case):
    """SDR's solve (``solve_ex`` without its status check), STOI's compaction
    and PIT's search below four speakers stay on the card."""
    M, tF = metrics_tpu_torch, metrics_tpu_torch.functional
    make, shape = {
        "snr": (lambda: M.SignalNoiseRatio(), (4, 8000)),
        "si-sdr": (lambda: M.ScaleInvariantSignalDistortionRatio(), (4, 8000)),
        "sdr": (lambda: M.SignalDistortionRatio(), (4, 8000)),
        "stoi": (lambda: M.ShortTimeObjectiveIntelligibility(16000), (4, 24000)),
        "stoi extended": (lambda: M.ShortTimeObjectiveIntelligibility(16000, extended=True), (4, 24000)),
        "pit 2": (lambda: M.PermutationInvariantTraining(tF.scale_invariant_signal_distortion_ratio), (4, 2, 8000)),
        "pit 3": (lambda: M.PermutationInvariantTraining(tF.signal_distortion_ratio, filter_length=128),
                  (2, 3, 8000)),
    }[case]
    m, ref = make(), make()
    batches = [_card_speech(card, shape, seed) for seed in (72, 73)]
    m.update(*batches[0])
    m.compute()  # warm: cuFFT plans, the permutation table
    _no_sync(lambda: m.update(*batches[1]))
    value = []
    _no_sync(lambda: value.append(m.compute()))
    for b in batches:
        ref.update(*b)
    assert torch.equal(value[0], ref.compute())


def test_sdr_on_the_card_equals_the_cpu_and_a_singular_system_is_nan(card):
    from metrics_tpu_torch.functional import signal_distortion_ratio

    p, t = _card_speech(card, (8, 16000), 74)
    got = signal_distortion_ratio(p, t)
    want = signal_distortion_ratio(p.cpu(), t.cpu())
    torch.testing.assert_close(got.cpu(), want, atol=1e-3, rtol=0)  # ~14 dB: 2e-5 * (1 + 10 ** 1.4) dB
    got64 = signal_distortion_ratio(p.double(), t.double())
    assert got64.dtype == torch.float64
    torch.testing.assert_close(got64.cpu(), signal_distortion_ratio(p.cpu().double(), t.cpu().double()), atol=1e-9,
                               rtol=0)
    singular = []
    _no_sync(lambda: singular.append(signal_distortion_ratio(p[:2], torch.zeros_like(p[:2]), filter_length=32)))
    assert torch.isnan(singular[0]).all()


def test_stoi_overlap_add_is_bit_stable_and_equals_the_cpu(card):
    """Each sample of the overlap-add has at most two addends: two runs on the
    card give the same bits, and so does the CPU."""
    from metrics_tpu_torch.functional.audio.stoi import _compact_loud_frames

    p, t = _card_speech(card, (8, 80000), 75)
    runs = [_compact_loud_frames(t, p, 256, 128) for _ in range(2)]
    cpu = _compact_loud_frames(t.cpu(), p.cpu(), 256, 128)
    assert int(runs[0][2].min()) < 80000 // 128 - 1  # the silent gap was dropped
    for a, b, c in zip(*runs, cpu):
        assert torch.equal(a, b) and torch.equal(a.cpu(), c)


def test_stoi_convolution_and_band_product_are_tf32_free_and_restore_the_flags(card):
    from metrics_tpu_torch.functional import short_time_objective_intelligibility

    p, t = _card_speech(card, (4, 32000), 76)
    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        values = {}
        for flag in (True, False):
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = flag
            values[flag] = short_time_objective_intelligibility(p, t, 16000)
            assert torch.backends.cudnn.allow_tf32 is flag and torch.backends.cuda.matmul.allow_tf32 is flag
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before
    assert torch.equal(values[True], values[False])
    torch.testing.assert_close(values[True].cpu(), short_time_objective_intelligibility(p.cpu(), t.cpu(), 16000),
                               atol=1e-5, rtol=0)


def test_pit_permutation_table_is_built_on_the_card_and_hungarian_reads_the_host_once(card):
    from metrics_tpu_torch.functional import permutation_invariant_training, scale_invariant_signal_distortion_ratio
    from metrics_tpu_torch.functional.audio.pit import _permutation_table

    for spk in (2, 3):
        p, t = _card_speech(card, (4, spk, 4000), 77 + spk)
        metric, perm = permutation_invariant_training(p, t, scale_invariant_signal_distortion_ratio)
        table = _permutation_table(spk, p.device)
        assert table.device == p.device and table.shape == (spk, int(np.prod(range(1, spk + 1))))
        assert perm.device == p.device and perm.dtype == torch.int32
        assert torch.equal(perm.cpu(), torch.arange(spk, dtype=torch.int32).expand(4, spk))
    p, t = _card_speech(card, (4, 5, 4000), 80)
    permutation_invariant_training(p, t, scale_invariant_signal_distortion_ratio)
    assert _sync_count(lambda: permutation_invariant_training(p, t, scale_invariant_signal_distortion_ratio)) == 1


def test_pit_engine_captures_and_replays_bit_equal_to_eager(card):
    M, tF = metrics_tpu_torch, metrics_tpu_torch.functional
    engine = M.PermutationInvariantTraining(tF.scale_invariant_signal_distortion_ratio, jit_update=True)
    eager = M.PermutationInvariantTraining(tF.scale_invariant_signal_distortion_ratio)
    batches = [_card_speech(card, (8, 2, 16000), seed) for seed in range(81, 85)]
    engine.update(*batches[0])
    for b in batches[1:]:
        _no_sync(lambda b=b: engine.update(*b))
    for b in batches:
        eager.update(*b)
    programs = list(engine._dispatcher._cache.values())
    assert len(programs) == 1 and len(programs[0].graphs) == 2
    for key in eager._defaults:
        assert torch.equal(getattr(engine, key), getattr(eager, key)), key
    stats = engine.dispatch_stats
    assert stats["dispatches"] == 4 and stats["retraces"] == 1 and stats["demotions"] == 0


TEXT_MODULES = {
    "WordErrorRate": {}, "CharErrorRate": {}, "MatchErrorRate": {}, "WordInfoLost": {}, "WordInfoPreserved": {},
    "BLEUScore": {}, "SacreBLEUScore": {"tokenize": "13a"}, "CHRFScore": {"return_sentence_level_score": True},
    "TranslationEditRate": {"return_sentence_level_score": True},
    "ExtendedEditDistance": {"return_sentence_level_score": True},
}
_TEXT_WORDS = ["the", "council", "said", "on", "Tuesday", "3.5", "U.S.", "don't", "end.", "why?", "a", "of"]


def _text_batches(seed, n=3, size=16):
    rng = np.random.RandomState(seed)
    batches = []
    for _ in range(n):
        preds, target = [], []
        for _ in range(size):
            ref = list(rng.choice(_TEXT_WORDS, rng.randint(1, 14)))
            hyp = [w if rng.rand() > 0.2 else rng.choice(_TEXT_WORDS) for w in ref if rng.rand() > 0.1]
            preds.append(" ".join(hyp))
            target.append(" ".join(ref))
        batches.append((preds, target))
    return batches


def _text_tolerance(name):
    """BLEU's ``log`` and ``exp`` and EED's ``nanmean`` round differently on the
    two devices: rtol 1e-6; every other text value is exact (host numbers,
    float32 sums and one division)."""
    inexact = ("bleu", "BLEU", "extended_edit_distance", "ExtendedEditDistance")
    return {"rtol": 1e-6, "atol": 0} if any(k in name for k in inexact) else {"rtol": 0, "atol": 0}


@pytest.mark.parametrize("name", sorted(TEXT_MODULES))
def test_text_metrics_live_on_the_card_and_equal_the_cpu(card, name):
    """No ``device``: the states are float32 on the card and equal the same
    module's on the CPU bit for bit (the counts are host numbers; both devices
    add them in float32 in one order); the values too, but BLEU's and EED's
    (rtol 1e-6)."""
    m = getattr(metrics_tpu_torch, name)(**TEXT_MODULES[name])
    ref = getattr(metrics_tpu_torch, name)(**TEXT_MODULES[name], device="cpu")
    for preds, target in _text_batches(90):
        m.update(preds, target)
        ref.update(preds, target)
    for key in m._defaults:
        got, want = getattr(m, key), getattr(ref, key)
        for g, w in zip(got, want) if isinstance(got, list) else [(got, want)]:
            assert g.device.type == "cuda" and g.dtype == torch.float32 and torch.equal(g.cpu(), w), key
    got, want = m.compute(), ref.compute()
    for g, w in zip(got, want) if isinstance(got, tuple) else [(got, want)]:
        assert g.device.type == "cuda"
        torch.testing.assert_close(g.cpu(), w, **_text_tolerance(name))


@pytest.mark.parametrize("name", ["WordErrorRate", "WordInfoLost", "BLEUScore", "CHRFScore", "TranslationEditRate",
                                  "ExtendedEditDistance"])
def test_text_updates_make_no_host_sync(card, name):
    """An update's counts reach the card from pinned memory (or as kernel
    arguments): the host never waits."""
    m = getattr(metrics_tpu_torch, name)(**TEXT_MODULES[name])
    batches = _text_batches(91)
    m.update(*batches[0])
    _no_sync(lambda: m.update(*batches[1]))


def test_bleu_compute_makes_no_host_sync_and_chrf_compute_reads_once(card):
    """BLEU selects its score on the card; chrF reads its three sums back in one piece."""
    bleu, chrf = metrics_tpu_torch.BLEUScore(), metrics_tpu_torch.CHRFScore()
    ter, eed = metrics_tpu_torch.TranslationEditRate(), metrics_tpu_torch.ExtendedEditDistance()
    for preds, target in _text_batches(92, n=2):
        for m in (bleu, chrf, ter, eed):
            m.update(preds, [[t] for t in target])
    assert _sync_count(bleu._compute_impl) == 0
    assert _sync_count(ter._compute_impl) == 0
    assert _sync_count(eed._compute_impl) == 0
    assert _sync_count(chrf._compute_impl) == 1


def test_text_engines_refuse_and_updates_run_eagerly_on_the_card(card):
    from metrics_tpu_torch.dispatch import FastDispatchUnsupported

    preds, target = _text_batches(93, n=1)[0]
    for name in sorted(TEXT_MODULES):
        with pytest.warns(UserWarning, match="host_only"):
            m = getattr(metrics_tpu_torch, name)(**TEXT_MODULES[name], jit_update=True)
        eager = getattr(metrics_tpu_torch, name)(**TEXT_MODULES[name])
        m.update(preds, target)
        eager.update(preds, target)
        assert m._dispatcher is None
        for key in m._defaults:
            got, want = getattr(m, key), getattr(eager, key)
            assert all(torch.equal(g, w) for g, w in zip(got, want)) if isinstance(got, list) else torch.equal(got, want)
        with pytest.raises(FastDispatchUnsupported, match="host_only"):
            m._make_dispatcher().update({}, (), (preds, target), {})


def test_text_functionals_run_on_the_card_and_equal_the_cpu(card):
    tF = metrics_tpu_torch.functional
    preds, target = _text_batches(94, n=1)[0]
    refs = [[t] for t in target]
    for fn, args in ((tF.word_error_rate, (preds, target)), (tF.char_error_rate, (preds, target)),
                     (tF.bleu_score, (preds, refs)), (tF.sacre_bleu_score, (preds, refs)),
                     (tF.chrf_score, (preds, refs)), (tF.translation_edit_rate, (preds, refs)),
                     (tF.extended_edit_distance, (preds, refs))):
        got, want = fn(*args), fn(*args, device="cpu")
        assert got.device.type == "cuda", fn.__name__
        torch.testing.assert_close(got.cpu(), want, **_text_tolerance(fn.__name__))


# ------------------------------------------------------- slice 19: ROUGE, SQuAD, BERTScore and mAP
_SUMM_WORDS = ["the", "council", "said", "on", "Tuesday", "shares", "rose", "by", "3.5", "percent", "Mr.", "U.S."]


def _summ_batches(seed, n=3, size=16):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        preds, target = [], []
        for _ in range(size):
            sents = [" ".join(rng.choice(_SUMM_WORDS, rng.randint(3, 10))).capitalize() + "." for _ in range(3)]
            preds.append(" ".join(sents[:2]))
            target.append(" ".join(s if rng.rand() > 0.3 else s[::-1] for s in sents))
        out.append((preds, target))
    return out


def test_rouge_batched_state_copy_equals_the_cpu_and_makes_no_host_sync(card):
    """An update's scores reach the card as one pinned buffer, split into
    ``(1,)`` views: the states equal the CPU's bit for bit, the means rtol
    1e-6, and a warm update never waits on the card."""
    m, ref = metrics_tpu_torch.ROUGEScore(), metrics_tpu_torch.ROUGEScore(device="cpu")
    batches = _summ_batches(95)
    for preds, target in batches[:2]:
        m.update(preds, target)
        ref.update(preds, target)
    _no_sync(lambda: m.update(*batches[2]))
    ref.update(*batches[2])
    for key in m._defaults:
        got, want = getattr(m, key), getattr(ref, key)
        assert len(got) == len(want) == 48, key
        assert all(g.device.type == "cuda" and g.shape == (1,) and torch.equal(g.cpu(), w) for g, w in zip(got, want))
    assert len({v.untyped_storage().data_ptr() for v in m.rouge1_fmeasure[32:]}) == 1  # one buffer a batch
    got, want = m.compute(), ref.compute()
    for key in want:
        assert got[key].device.type == "cuda"
        torch.testing.assert_close(got[key].cpu(), want[key], rtol=1e-6, atol=0)


def test_squad_on_the_card_equals_the_cpu_and_updates_without_a_sync(card):
    preds = [{"prediction_text": t, "id": str(i)} for i, (t, _) in enumerate(zip(*_summ_batches(96, n=1)[0]))]
    target = [{"answers": {"text": [r[:20], r]}, "id": str(i)} for i, r in enumerate(_summ_batches(96, n=1)[0][1])]
    m, ref = metrics_tpu_torch.SQuAD(), metrics_tpu_torch.SQuAD(device="cpu")
    m.update(preds[:8], target[:8])
    _no_sync(lambda: m.update(preds[8:], target[8:]))
    ref.update(preds[:8], target[:8])
    ref.update(preds[8:], target[8:])
    for key in m._defaults:
        assert getattr(m, key).device.type == "cuda" and torch.equal(getattr(m, key).cpu(), getattr(ref, key)), key
    for key, value in ref.compute().items():
        assert torch.equal(m.compute()[key].cpu(), value), key


def test_bert_matcher_on_the_card_equals_the_cpu(card):
    """The special-token exclusion's running sums are bit-equal on both
    devices (float32 adds in one order) and make no host sync; the matcher's precision, recall and
    F1 within rtol 1e-5 (a TF32-free product, summed in another order)."""
    from metrics_tpu_torch.functional.text import bert

    rng = np.random.RandomState(97)
    for length in (7, 16, 40, 300):
        mask = torch.from_numpy((rng.rand(256, length) < rng.rand(256, 1)).astype(np.int32))
        on_card = mask.to(card)
        _no_sync(lambda: bert._exclude_special_tokens(on_card))
        assert torch.equal(bert._exclude_special_tokens(on_card).cpu(), bert._exclude_special_tokens(mask))
    n, lp, lt, d = 64, 40, 57, 1024
    pe, te = (torch.from_numpy(rng.standard_normal((n, l, d)).astype(np.float32)) for l in (lp, lt))
    pm, tm = (torch.from_numpy((np.arange(l)[None] < rng.randint(1, l + 1, (n, 1))).astype(np.int32)) for l in (lp, lt))
    pw, tw = torch.rand(n, lp), torch.rand(n, lt)
    for weights in ((None, None), (pw, tw)):
        want = bert._greedy_cosine_match(pe, pm, te, tm, *weights)
        got = bert._greedy_cosine_match(pe.to(card), pm.to(card), te.to(card), tm.to(card),
                                        *(w if w is None else w.to(card) for w in weights))
        for g, w in zip(got, want):
            assert g.device.type == "cuda"
            torch.testing.assert_close(g.cpu(), w, rtol=1e-5, atol=1e-6)
    preds, target = _summ_batches(98, n=1)[0]
    for idf in (False, True):
        got = metrics_tpu_torch.functional.bert_score(preds, target, idf=idf)
        want = metrics_tpu_torch.functional.bert_score(preds, target, idf=idf, device="cpu")
        for key in want:
            assert got[key].device.type == "cuda"
            torch.testing.assert_close(got[key].cpu(), want[key], rtol=1e-5, atol=1e-6)


def _card_detections(seed, n, dev):
    rng = np.random.RandomState(seed)
    preds, target = [], []
    for _ in range(n):
        gt = rng.uniform(0, 400, (7, 2))
        gt = np.concatenate([gt, gt + rng.uniform(10, 200, (7, 2))], 1).astype(np.float32)
        labels = rng.randint(0, 80, 7)
        det = np.concatenate([gt, gt + rng.normal(0, 5, gt.shape)]).astype(np.float32)
        det[:, 2:] = np.maximum(det[:, 2:], det[:, :2] + 1)
        preds.append({"boxes": torch.from_numpy(det).to(dev), "scores": torch.rand(14, device=dev),
                      "labels": torch.from_numpy(np.concatenate([labels, labels])).to(dev)})
        target.append({"boxes": torch.from_numpy(gt).to(dev), "labels": torch.from_numpy(labels).to(dev)})
    return preds, target


def test_map_compute_reads_the_card_once_and_equals_the_cpu(card):
    """Every image's arrays cross in one device-to-host copy; the result
    comes back from pinned memory; the values equal the CPU's bit for bit."""
    from metrics_tpu_torch.detection import MeanAveragePrecision

    preds, target = _card_detections(99, 40, card)
    m = MeanAveragePrecision(class_metrics=True)
    ref = MeanAveragePrecision(class_metrics=True, device="cpu")
    m.update(preds, target)
    ref.update([{k: v.cpu() for k, v in p.items()} for p in preds], [{k: v.cpu() for k, v in t.items()} for t in target])
    assert all(v.device.type == "cuda" for key in m._defaults for v in getattr(m, key))
    assert _sync_count(m._compute_impl) == 1
    got, want = m.compute(), ref.compute()
    assert list(got) == list(want)
    for key in want:
        assert got[key].device.type == "cuda" and got[key].dtype == want[key].dtype
        assert torch.equal(got[key].cpu(), want[key]), key


# ------------------------------------------------------------------ slice 20: the nets and their metrics
def _nets_images(n, hw, seed=0, dtype=torch.uint8):
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(0, 256, (n, 3, hw, hw), generator=g, dtype=torch.uint8)
    return x if dtype == torch.uint8 else x.to(dtype) / 127.5 - 1.0


def test_inception_on_the_card_equals_the_cpu(card):
    """The seeded extractor at 299 x 299: the card's float32 (TF32 off) pool
    features, logits and 768 tap within 1e-4 of the CPU's largest magnitude."""
    from metrics_tpu_torch.image import InceptionV3FeatureExtractor

    x = _nets_images(4, 299, seed=1)
    for output in ("pool", "logits_unbiased", 768):
        with pytest.warns(UserWarning):
            cpu = InceptionV3FeatureExtractor(output=output)
        want = cpu(x)
        got = cpu.to(card)(x.to(card)).cpu()
        assert got.dtype == want.dtype == torch.float32 and got.shape == want.shape
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_inception_bf16_stays_within_its_bound(card):
    """The bf16 option: float32 outputs within 5% of the float32 features' scale."""
    from metrics_tpu_torch.image import InceptionV3FeatureExtractor

    x = _nets_images(8, 299, seed=2).to(card)
    with pytest.warns(UserWarning):
        f32 = InceptionV3FeatureExtractor().to(card)
        bf16 = InceptionV3FeatureExtractor(dtype=torch.bfloat16).to(card)  # the same seeded weights
    want, got = f32(x), bf16(x)
    assert got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 5e-2 * float(want.abs().max())


@pytest.mark.parametrize("net", ["alex", "vgg", "squeeze"])
def test_lpips_nets_on_the_card_equal_the_cpu(card, net):
    from metrics_tpu_torch.image.lpips_net import LPIPSNet

    a, b = _nets_images(6, 64, seed=3, dtype=torch.float32), _nets_images(6, 64, seed=4, dtype=torch.float32)
    with pytest.warns(UserWarning):
        cpu = LPIPSNet(net_type=net)
    want = cpu(a, b)
    got = cpu.to(card)(a.to(card), b.to(card)).cpu()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_fid_card_eigh_equals_eigh_host(card):
    """``sqrtm_method=None`` on the card is cuSOLVER's eigh; ``eigh_host``
    the CPU's: within 1e-4 of tr(S1) + tr(S2)."""
    from metrics_tpu_torch import FrechetInceptionDistance

    g = torch.Generator(device=card).manual_seed(5)
    real = torch.randn(4096, 256, generator=g, device=card) @ torch.randn(256, 256, generator=g, device=card) / 16
    fake = torch.randn(4096, 256, generator=g, device=card) * 1.1 + 0.2
    values = {}
    for method in (None, "eigh_host"):
        m = FrechetInceptionDistance(feature_dim=256, sqrtm_method=method, device=card)
        m.update(real, real=True)
        m.update(fake, real=False)
        values[method] = float(m.compute())
    scale = float(torch.trace(torch.cov(real.T)) + torch.trace(torch.cov(fake.T)))
    assert abs(values[None] - values["eigh_host"]) <= 1e-4 * scale


@pytest.mark.parametrize("key", [None, 3], ids=["round-robin", "keyed"])
def test_is_streaming_on_the_card_equals_the_cpu(card, key):
    """IS's streaming sums (a one-hot product) on the card against a CPU run
    of the same metric on the same logits: ``split_count`` equal, the sums
    within 1e-5 of their scale, the mean and std at rtol 1e-5."""
    from metrics_tpu_torch import InceptionScore

    g = torch.Generator().manual_seed(8)
    logits = [torch.randn(n, 50, generator=g) * 3 for n in (64, 17, 100, 33)]
    on_card = InceptionScore(splits=7, num_classes=50, assignment_rng_key=key, device=card)
    on_cpu = InceptionScore(splits=7, num_classes=50, assignment_rng_key=key, device="cpu")
    for x in logits:
        on_card.update(x.to(card))
        on_cpu.update(x)
    assert torch.equal(on_card.split_count.cpu(), on_cpu.split_count)
    for name in ("prob_sum", "plogp_sum"):
        want = getattr(on_cpu, name)
        assert float((getattr(on_card, name).cpu() - want).abs().max()) <= 1e-5 * float(want.abs().max()), name
    for got, want in zip(on_card.compute(), on_cpu.compute()):
        assert abs(float(got) - float(want)) <= 1e-5 * abs(float(on_cpu.compute()[0]))


def _engine_pair(card, cls, kwargs, batches):
    eager, engine = cls(**kwargs, device=card), cls(**kwargs, jit_update=True, device=card)
    for args, kw in batches:
        eager.update(*args, **kw)
        engine.update(*args, **kw)
    torch.cuda.synchronize()
    return eager, engine


def test_captured_updates_equal_eager_on_the_card(card):
    """LPIPS (its net inside the graph), FID's moments, KID's buffer and IS's
    streaming sums with ``fold_in`` on the device count: each update a replay
    of a captured graph, the states the eager updates' bits."""
    import metrics_tpu_torch as M

    g = torch.Generator(device=card).manual_seed(6)
    imgs = [torch.rand(4, 3, 64, 64, generator=g, device=card) * 2 - 1 for _ in range(3)]
    lp = [((x, (x + 0.1 * torch.randn(x.shape, generator=g, device=card)).clamp(-1, 1)), {}) for x in imgs]
    feats = [((torch.randn(32, 64, generator=g, device=card),), {"real": bool(i % 2)}) for i in range(6)]
    logits = [((torch.randn(32, 10, generator=g, device=card),), {}) for _ in range(4)]
    cases = [
        (M.LearnedPerceptualImagePatchSimilarity, {"net_type": "alex"}, lp),
        (M.FrechetInceptionDistance, {"feature_dim": 64}, feats),
        (M.KernelInceptionDistance, {"feature_dim": 64, "max_samples": 512, "subset_size": 16, "subsets": 3}, feats),
        (M.InceptionScore, {"num_classes": 10, "splits": 4, "assignment_rng_key": 3}, logits),
    ]
    for cls, kwargs, batches in cases:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the seeded LPIPS network's warning
            eager, engine = _engine_pair(card, cls, kwargs, batches)
        for key in eager._defaults:
            assert torch.equal(getattr(engine, key), getattr(eager, key)), (cls.__name__, key)
        stats = engine.dispatch_stats
        assert stats["demotions"] == 0 and stats["dispatches"] == len(batches), (cls.__name__, stats)
        assert any(len(p.graphs) == 2 for p in engine._dispatcher._cache.values()), cls.__name__


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
def test_fid_with_the_network_in_the_graph_equals_eager_on_the_card(card, dtype):
    """FID as the benchmark's ``fid_inception`` cell runs it, at a small batch: the bundled InceptionV3
    with ``resize=299`` on 256 x 256 uint8 images, batches of 4 and a last of 2, the moment sums in
    float32 or (``set_dtype``, the cell's) float64. Each engine update (the cast, the resize, the trunk's
    convolutions, the moment sums) is one replay of a captured graph: the states are the eager updates'
    bits, nothing is demoted, the real side survives ``reset()``, and the program's phase marks read
    format, extract, count, writeback, end."""
    import metrics_tpu_torch as M
    from metrics_tpu_torch import telemetry
    from metrics_tpu_torch.image.inception_net import InceptionV3FeatureExtractor

    g = torch.Generator(device=card).manual_seed(26)

    def batch(n):
        return torch.randint(0, 256, (n, 3, 256, 256), generator=g, device=card, dtype=torch.uint8)

    real, fake = [batch(4), batch(2)], [batch(4), batch(4), batch(2)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the seeded network's warning
        eager, engine = (M.FrechetInceptionDistance(feature_extractor=InceptionV3FeatureExtractor(resize=299),
                                                    feature_dim=2048, reset_real_features=False, jit_update=jit,
                                                    device=card).set_dtype(dtype) for jit in (False, True))
    with telemetry.instrument() as session:
        for m in (eager, engine):
            for x in real:
                m.update(x, real=True)
            kept = {k: getattr(m, k).clone() for k in m._defaults if k.startswith("real")}
            m.reset()
            for x in fake:
                m.update(x, real=False)
            assert all(torch.equal(getattr(m, k), v) for k, v in kept.items())
    torch.cuda.synchronize()
    for key in eager._defaults:
        assert torch.equal(getattr(engine, key), getattr(eager, key)), key
    assert int(engine.real_num_samples) == 6 and int(engine.fake_num_samples) == 10
    assert engine.real_outer_sum.dtype == engine.fake_features_sum.dtype == dtype
    stats = engine.dispatch_stats
    assert stats["demotions"] == 0 and stats["dispatches"] == 5, stats
    programs = engine._dispatcher._cache.values()
    assert len(programs) == 4 and all(len(p.graphs) == 2 for p in programs)  # (real, fake) x (4, 2 rows)
    builds = session.spans(name="compile", owner="FrechetInceptionDistance")
    phases = ("format", "extract", "count", "writeback", "end")
    assert len(builds) == 4 and all(b.attrs["marks"] == tuple(("FrechetInceptionDistance", p) for p in phases)
                                    for b in builds)
    assert _marked_phases(card, lambda: engine.update(fake[0], real=False)) == list(phases)
    assert bool(torch.isfinite(engine.compute()))


# ------------------------------------------------------------------ the static audit's predictions on the card
def _audit_case(name):
    from metrics_tpu_torch.analysis import registry as audit_registry

    return next(c for c in audit_registry.audit_cases() if c.name == name)


def _sync_errors(fn):
    """``fn()`` with every host sync an error: None, or the error."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except Exception as err:  # noqa: BLE001 -- what the audit predicted, or not
        return err
    finally:
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    return None


@pytest.mark.parametrize("name", ["Accuracy", "ConfusionMatrix", "MeanSquaredError", "SlidingWindow"])
def test_an_update_the_audit_calls_clean_captures_without_a_sync(card, name):
    """The engine captures the update of a case the static audit calls clean
    with every host sync an error, and its replay is the eager bits
    (``_bincount`` is a fixed-shape scatter: ConfusionMatrix's default path
    captures)."""
    from metrics_tpu_torch.analysis import registry as audit_registry
    from metrics_tpu_torch.utilities.checks import tracing

    case = _audit_case(name)
    pools = audit_registry.example_inputs(card)
    args = case.args(pools)
    ref = case.build(card)
    with tracing():
        want = ref.pure_update(ref.pure_update(ref.default_state(), *args), *args)
    metric = case.build(card)
    engine = metric._make_dispatcher()
    assert _sync_errors(lambda: [engine.update({}, (), args, {}) for _ in range(2)]) is None
    assert any(len(p.graphs) == 2 for p in engine._cache.values())
    for key in metric._defaults:
        got = getattr(metric, key)
        assert got.dtype == want[key].dtype and torch.allclose(got, want[key], rtol=1e-6, atol=1e-12)
        if not got.is_floating_point():
            assert torch.equal(got, want[key])


def test_the_audits_findings_raise_on_the_card(card):
    """AUROC's compute (JX401) reads the card back: the sync debug mode's
    error; SDR's update (JX301, a CUDA solve no graph can hold) breaks its
    capture. Any other error would be a fault, not the finding."""
    from metrics_tpu_torch.analysis import registry as audit_registry
    from metrics_tpu_torch.utilities.checks import tracing

    pools = audit_registry.example_inputs(card)
    auroc_case = _audit_case("AUROC")
    auroc = auroc_case.build(card)
    with tracing():
        state = auroc.pure_update(auroc.default_state(), *auroc_case.args(pools))
    err = _sync_errors(lambda: auroc.pure_compute(state))
    assert isinstance(err, RuntimeError) and "called a synchronizing CUDA operation" in str(err), err
    sdr_case = _audit_case("SignalDistortionRatio")
    engine = sdr_case.build(card)._make_dispatcher()
    err = _sync_errors(lambda: engine.update({}, (), sdr_case.args(pools), {}))
    chain = [err]
    while chain[-1] is not None and len(chain) < 8:  # the error and those it was raised from or in
        chain.append(chain[-1].__cause__ or chain[-1].__context__)
    assert any("cudaErrorStreamCaptureInvalidated" in str(e) for e in chain if e is not None), err


def test_a_pth_and_its_npz_give_the_same_inception_features_on_the_card(card, tmp_path):
    from metrics_tpu_torch.image import inception_net

    g = torch.Generator().manual_seed(21)
    state = {k: v + 0.01 * torch.randn(v.shape, generator=g) if v.is_floating_point() else v
             for k, v in inception_net.InceptionV3().state_dict().items()}
    state = {k: v.abs() if k.endswith("running_var") else v for k, v in state.items()}
    pth, npz = str(tmp_path / "w.pth"), str(tmp_path / "w.npz")
    torch.save(state, pth)
    inception_net.save_params(npz, inception_net.convert_torch_state_dict(state))
    images = torch.rand(8, 3, 299, 299, generator=torch.Generator(device=card).manual_seed(0), device=card) * 2 - 1
    a = inception_net.InceptionV3FeatureExtractor(weights_path=pth).to(card)(images)
    b = inception_net.InceptionV3FeatureExtractor(weights_path=npz).to(card)(images)
    assert torch.isfinite(a).all() and torch.equal(a, b)


# ------------------------------------------------------------------ device phase marks
MARKS_C = 20


def _segmentation_collection(card):
    return metrics_tpu_torch.MetricCollection(
        [metrics_tpu_torch.JaccardIndex(num_classes=MARKS_C, ignore_index=MARKS_C - 1, update_method="matmul",
                                        jit_update=True, device=card),
         metrics_tpu_torch.Accuracy(num_classes=MARKS_C, ignore_index=MARKS_C - 1, mdmc_average="global",
                                    jit_update=True, device=card)],
        fused_update=True, compute_groups=True)


def _segmentation_batches(card, n=4):
    g = torch.Generator(device=card).manual_seed(90)
    return [(torch.rand(4, MARKS_C, 64, 128, generator=g, device=card),
             torch.randint(0, MARKS_C, (4, 64, 128), generator=g, device=card)) for _ in range(n)]


def _marked_phases(card, fn):
    """The phases of the phase-mark kernels a profiled ``fn`` ran on the card, in device order; the
    profiler may lose device activities, so an empty capture is taken again (three in all)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize(card)
        kernels = sorted((e.time_range.start, e.name) for e in prof.events()
                         if str(e.device_type).endswith("CUDA") and not e.is_user_annotation)
        if kernels:
            return [name.split("phase_mark_", 1)[1].split("(", 1)[0] for _, name in kernels if "phase_mark_" in name]
    pytest.fail("no device activity in three profiler captures")


def test_a_profiled_replay_shows_each_members_phase_marks_in_order(card):
    from metrics_tpu_torch import telemetry

    mc, batches = _segmentation_collection(card), _segmentation_batches(card)
    with telemetry.instrument() as session:
        for b in batches[:2]:
            mc.update(*b)
    (build,) = session.spans(name="compile")
    assert build.attrs["marks"] == (("JaccardIndex", "format"), ("JaccardIndex", "count"), ("Accuracy", "format"),
                                    ("Accuracy", "count"), ("MetricCollection", "writeback"),
                                    ("MetricCollection", "end"))
    assert _marked_phases(card, lambda: mc.update(*batches[2])) == [
        "format", "count", "format", "count", "writeback", "end"]
    eager = metrics_tpu_torch.Accuracy(num_classes=MARKS_C, ignore_index=MARKS_C - 1, mdmc_average="global",
                                       device=card)
    assert _marked_phases(card, lambda: eager.update(*batches[3])) == []  # an eager call places none


def test_marked_graphs_count_what_unmarked_graphs_count_bit_for_bit(card, monkeypatch):
    batches = _segmentation_batches(card)
    results = []
    for switch in ("1", "0"):  # marks captured, then none: METRICS_TPU_TELEMETRY is read at the capture
        monkeypatch.setenv("METRICS_TPU_TELEMETRY", switch)
        mc = _segmentation_collection(card)
        for b in batches:
            mc.update(*b)
        values = mc.compute()
        results.append((mc["JaccardIndex"].confmat.clone(), {k: v.clone() for k, v in values.items()}))
        assert mc.dispatch_stats["demotions"] == 0
        want = ["format", "count", "format", "count", "writeback", "end"] if switch == "1" else []
        assert _marked_phases(card, lambda: mc.update(*batches[0])) == want
    (marked_cm, marked), (plain_cm, plain) = results
    assert torch.equal(marked_cm, plain_cm) and int(marked_cm.sum()) > 0
    assert marked.keys() == plain.keys() and all(torch.equal(marked[k], plain[k]) for k in marked)


def test_the_cells_collection_counts_from_labels_what_the_one_hot_route_counted(card):
    """The benchmark cells' collection on a small Cityscapes-shaped batch: the captured replays' confusion
    matrix and tp/fp/tn/fn equal an eager run of the one-hot route (one-hots, argmax back, the one-hot
    stat scores) bit for bit, ties and NaN score rows included; the phase marks keep their order, and every
    member update took the label route."""
    import importlib.util
    from pathlib import Path

    from metrics_tpu_torch import telemetry

    # loaded by path: this file runs without the repo's conftest, which puts the root on sys.path
    spec = importlib.util.spec_from_file_location("onehot_route", Path(__file__).parent / "helpers" / "onehot_route.py")
    onehot_route = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(onehot_route)
    onehot_confmat, onehot_stat_scores = onehot_route.onehot_confmat, onehot_route.onehot_stat_scores

    g = torch.Generator(device=card).manual_seed(91)
    batches = []
    for i in range(3):
        scores = torch.rand(2, MARKS_C, 256, 512, generator=g, device=card)
        scores[:, :, ::3] = (scores[:, :, ::3] * 4).round()  # every 3rd row's maxima tie often
        scores[i % 2, i + 2, ::17, ::13] = float("nan")  # NaN ranks as the maximum
        batches.append((scores, torch.randint(0, MARKS_C, (2, 256, 512), generator=g, device=card)))
    mc = _segmentation_collection(card)
    telemetry.reset_counters()
    for b in batches:  # the first call builds (its warm-up run serves it), the others replay
        mc.update(*b)
    torch.cuda.synchronize(card)
    stats = mc.dispatch_stats
    assert (stats["dispatches"], stats["retraces"], stats["demotions"]) == (3, 1, 0)
    counters = telemetry.snapshot()
    assert counters.get("format:labels") == 2 * len(batches) and "format:onehot" not in counters

    want_cm = sum(onehot_confmat(p, t, MARKS_C) for p, t in batches)
    want = [sum(c) for c in zip(*(onehot_stat_scores(p, t, "micro", MARKS_C, MARKS_C - 1) for p, t in batches))]
    got_cm = mc["JaccardIndex"].confmat
    assert got_cm.dtype == torch.int32 and torch.equal(got_cm, want_cm) and int(got_cm.sum()) == 3 * 2 * 256 * 512
    for name, w in zip(("tp", "fp", "tn", "fn"), want):
        got = getattr(mc["Accuracy"], name)
        assert got.dtype == w.dtype == torch.int32 and torch.equal(got, w), name
    assert _marked_phases(card, lambda: mc.update(*batches[0])) == [
        "format", "count", "format", "count", "writeback", "end"]
