"""The port's kernel modules held against the JAX package on the CPU.

For each kernel, the port's plain PyTorch version (what a CPU tensor runs)
must equal, bit for bit and in dtype, both formulations of the JAX package:
the lax fallback (``force_pallas=False``) and the Pallas kernel body run in
interpret mode. The Pallas body is called directly (``_stat_counts_pallas``,
``_confmat_pallas``), not through the registry, whose launch fallback could
otherwise hide a failure. The grids are those of
``tests/ops/test_kernel_parity.py``. The CUDA kernels themselves run only on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import os
import stat
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu.ops.confusion import _confmat_pallas
from metrics_tpu.ops.confusion import confusion_matrix_counts as jax_confusion_matrix_counts
from metrics_tpu.ops.stat_scores import _stat_counts_pallas
from metrics_tpu.ops.stat_scores import stat_scores_counts as jax_stat_scores_counts
from metrics_tpu_torch.ops import _build, confusion_matrix_counts, launches, registry, stat_scores_counts
from metrics_tpu_torch.ops.retrieval import L_MAX, sort_branch
from metrics_tpu_torch.ops.binned_stats import binned_plan, branch_name, hist_max_thresholds, hist_shared_bytes
from metrics_tpu_torch.ops.confusion import band_shared_bytes, confusion_plan, split_shared_bytes
from metrics_tpu_torch.ops.confusion import branch_name as confusion_branch_name
from metrics_tpu_torch.ops.sketch_ops import countmin_plan
from metrics_tpu_torch.ops.stat_scores import stat_scores_plan


def _stat_inputs(n, c, seed):
    rng = np.random.RandomState(seed)
    target = rng.randint(0, c, n).astype(np.int32)
    pred = rng.randint(0, c, n).astype(np.int32)
    w = rng.randint(0, 2, n).astype(np.int32)  # 0/1 validity: masked rows
    correct = (pred == target) & (w > 0)
    return target, pred, correct, w


def _port_counts(target, pred, correct, w, c):
    return stat_scores_counts(
        torch.from_numpy(target), torch.from_numpy(pred), torch.from_numpy(correct), torch.from_numpy(w), c
    )


# ------------------------------------------------------------- stat scores
@pytest.mark.parametrize("n", [1, 100, 128, 129, 512])
@pytest.mark.parametrize("c", [2, 7, 33])
def test_stat_scores_plain_matches_jax_lax_and_pallas(n, c):
    target, pred, correct, w = _stat_inputs(n, c, seed=n + c)
    got = _port_counts(target, pred, correct, w, c)

    jt, jp, jw = jnp.asarray(target), jnp.asarray(pred), jnp.asarray(w)
    jc = jnp.asarray(correct)
    lax = jax_stat_scores_counts(jt, jp, jc, jw, c, force_pallas=False)
    pallas = _stat_counts_pallas(jt, jp, jc.astype(jnp.float32), jw.astype(jnp.float32), c, interpret=True)
    pallas = [pallas[i].astype(jw.dtype) for i in range(3)]
    for name, g, ref_lax, ref_pallas in zip(("targ", "pred", "tp"), got, lax, pallas):
        assert g.dtype == torch.int32 and np.asarray(ref_lax).dtype == np.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(ref_lax), err_msg=f"{name} vs lax")
        np.testing.assert_array_equal(g.numpy(), np.asarray(ref_pallas), err_msg=f"{name} vs pallas")


def _assert_jax_scatter(target, pred, w, c):
    """The port's counts equal the JAX package's production scatter
    (``force_pallas=False``) exactly, out-of-range classes included."""
    correct = (pred == target) & (w > 0)
    got = _port_counts(target, pred, correct, w, c)
    ref = jax_stat_scores_counts(jnp.asarray(target), jnp.asarray(pred), jnp.asarray(correct), jnp.asarray(w), c,
                                 force_pallas=False)
    for g, r in zip(got, ref):
        assert g.dtype == torch.int32 and np.asarray(r).dtype == np.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    return got


def test_stat_scores_out_of_range_class_adds_nothing():
    # flat indices k*C + cls outside [-3C, 3C) are dropped, as JAX's scatter drops them
    c = 3
    target = np.array([0, 1, 2, 9, -10], np.int32)
    pred = np.array([3 * c, 1, -5 * c, 0, 2], np.int32)
    targ, prd, tp = _assert_jax_scatter(target, pred, np.ones(5, np.int32), c)
    assert targ.tolist() == [1, 1, 1] and prd.tolist() == [1, 1, 1] and tp.tolist() == [0, 1, 0]


@pytest.mark.parametrize("pred_cls", ["C", "0"])
@pytest.mark.parametrize("masked_negative_target", [False, True])
def test_stat_scores_flat_index_rule_matches_jax_scatter(pred_cls, masked_negative_target):
    # a NaN score row has pred_cls == C: JAX's scatter adds it at flat index 2C, which is tp[0];
    # a negative target under w = 0 wraps into range but adds weight 0
    c = 5
    target, pred, _, w = _stat_inputs(64, c, seed=11)
    w = np.ones_like(w)
    pred[::4] = c if pred_cls == "C" else 0
    if masked_negative_target:
        target[1::6] = -1
        target[2::6] = -3 * c
        w[1::6] = 0
        w[2::6] = 0
    targ, prd, tp = _assert_jax_scatter(target, pred, w, c)
    if pred_cls == "C":
        assert int(tp[0]) >= int(((pred == c) & (w > 0)).sum()) > 0


def test_stat_scores_empty_batch_gives_zeros():
    empty = np.zeros(0, np.int32)
    out = _port_counts(empty, empty, empty.astype(bool), empty, 4)
    assert all(o.tolist() == [0] * 4 and o.dtype == torch.int32 for o in out)


@pytest.mark.parametrize(
    "field,bad",
    [("target", torch.zeros(4, dtype=torch.int64)), ("correct", torch.zeros(4, dtype=torch.int32)), ("w", torch.zeros(4))],
)
def test_stat_scores_wrapper_rejects_wrong_dtype(field, bad):
    args = {
        "target": torch.zeros(4, dtype=torch.int32),
        "pred": torch.zeros(4, dtype=torch.int32),
        "correct": torch.zeros(4, dtype=torch.bool),
        "w": torch.ones(4, dtype=torch.int32),
    }
    args[field] = bad
    with pytest.raises(TypeError, match="must be"):
        stat_scores_counts(args["target"], args["pred"], args["correct"], args["w"], 3)


def test_stat_scores_wrapper_rejects_shape_and_layout():
    ok = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="shape"):
        stat_scores_counts(ok, torch.zeros(5, dtype=torch.int32), ok.bool(), ok, 3)
    strided = torch.zeros(8, dtype=torch.int32)[::2]
    with pytest.raises(ValueError, match="contiguous"):
        stat_scores_counts(ok, strided, ok.bool(), ok, 3)


# -------------------------------------------------------- confusion matrix
@pytest.mark.parametrize("n", [1, 64, 128, 200, 1024])
@pytest.mark.parametrize("c", [2, 10, 40])
def test_confusion_plain_matches_jax_lax_and_pallas(n, c):
    rng = np.random.RandomState(n * 7 + c)
    target = rng.randint(0, c, n).astype(np.int32)
    pred = rng.randint(0, c, n).astype(np.int32)
    got = confusion_matrix_counts(torch.from_numpy(target), torch.from_numpy(pred), c)

    jt, jp = jnp.asarray(target), jnp.asarray(pred)
    lax = np.asarray(jax_confusion_matrix_counts(jt, jp, c, force_pallas=False))
    pallas = np.asarray(_confmat_pallas(jt, jp, c, interpret=True).astype(jnp.int32))
    assert got.dtype == torch.int32 and lax.dtype == np.int32 and got.shape == (c, c)
    np.testing.assert_array_equal(got.numpy(), lax)
    np.testing.assert_array_equal(got.numpy(), pallas)
    assert int(got.sum()) == n


def test_confusion_padding_label_matches_no_class():
    target = torch.tensor([0, -1, 1, 2], dtype=torch.int32)
    pred = torch.tensor([0, 1, -1, 2], dtype=torch.int32)
    got = confusion_matrix_counts(target, pred, 3)
    ref = np.asarray(_confmat_pallas(jnp.asarray(target.numpy()), jnp.asarray(pred.numpy()), 3, interpret=True))
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int32))
    assert int(got.sum()) == 2


def test_confusion_wrapper_rejects_bad_inputs():
    ok = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        confusion_matrix_counts(ok.long(), ok, 3)
    with pytest.raises(ValueError, match="1-D"):
        confusion_matrix_counts(ok, torch.zeros(3, dtype=torch.int32), 3)
    with pytest.raises(ValueError, match="positive"):
        confusion_matrix_counts(ok, ok, 0)


# ---------------------------------------------------------------- routing
def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    registry.reset_launches()
    target, pred, correct, w = _stat_inputs(64, 5, seed=3)
    _port_counts(target, pred, correct, w, 5)
    confusion_matrix_counts(torch.from_numpy(target), torch.from_numpy(pred), 5)
    assert launches() == {name: 0 for name in registry.KERNELS}
    assert set(registry.KERNELS) == {"stat_scores", "confusion_matrix", "binned_stats", "retrieval_sort", "countmin"}


@pytest.mark.parametrize(
    "notes,want",
    [
        ([("block", (1024, 1000))] * 48 + [("block", (848, 1000))], {("block", (1024, 1000)): 48, ("block", (848, 1000)): 1}),
        ([("hist", (1024, 80, 100)), ("hist, clusters of 8", (40504, 80, 100)), ("hist", (1024, 80, 100))],
         {("hist", (1024, 80, 100)): 2, ("hist, clusters of 8", (40504, 80, 100)): 1}),
        ([("bitonic", (6980, 1024))] * 3, {("bitonic", (6980, 1024)): 3}),
    ],
)
def test_launches_are_counted_by_branch_and_shape(notes, want):
    registry.reset_launches()
    for branch, shape in notes:
        registry.note_launch("binned_stats", branch, shape)
    assert launches()["binned_stats"] == len(notes)
    assert registry.launches_by_shape("binned_stats") == want
    assert registry.launches_by_shape("stat_scores") == {}
    registry.reset_launches()
    assert registry.launches_by_shape("binned_stats") == {} and launches()["binned_stats"] == 0


def test_other_devices_raise():
    meta = torch.empty(4, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        confusion_matrix_counts(meta, meta, 3)
    with pytest.raises(RuntimeError, match="same device"):
        confusion_matrix_counts(torch.zeros(4, dtype=torch.int32), meta, 3)


# ----------------------------------------------------- launch rules (host side)
@pytest.mark.parametrize(
    "l,all_pairs,want",
    [(1, False, "bitonic"), (1000, False, "bitonic"), (1024, False, "bitonic"), (4097, False, "bitonic"),
     (L_MAX, False, "bitonic"), (L_MAX + 1, False, "all_pairs"), (100_000, False, "all_pairs"),
     (1, True, "all_pairs"), (1024, True, "all_pairs")],
)
def test_retrieval_sort_branch_follows_the_row_length(l, all_pairs, want):
    assert L_MAX == 16384  # 16,384 composites of 8 bytes fit a block's 227 KB of shared memory
    assert sort_branch(l, all_pairs) == want


H100 = (132, 232_448)  # SMs, and the opt-in shared memory of a block in bytes


@pytest.mark.parametrize(
    "n,depth,width,want",
    [
        (65536, 4, 1024, ("shared", 128, 8)),  # the click-stream batch: 512 keys a block, 128 of 132 SMs
        (10_000_000, 4, 1024, ("shared", 132, 8)),  # one block an SM at most
        (1, 4, 1024, ("shared", 1, 8)),
        (257, 1, 1000, ("shared", 1, 8)),
        (65536, 8, 1023, ("shared", 128, 7)),  # 7 private tables of 32 KB fit
        (65536, 1, 58080, ("shared", 128, 1)),  # one table and 32 weights: exactly the limit
        (65536, 1, 58081, ("global", 256, 8)),
        (65536, 1, 58077, ("shared", 128, 1)),  # a table's stride is rounded up to whole float4s: 58,080
        (65536, 4, 65536, ("global", 256, 8)),  # 1 MB: global atomics, one block a 256 keys
        (10_000_000, 4, 65536, ("global", 1056, 8)),  # at most 8 blocks an SM
    ],
)
def test_countmin_plan_sizes_the_grid_from_the_card(n, depth, width, want):
    assert countmin_plan(n, depth, width, *H100) == want


@pytest.mark.parametrize(
    "n,c,want",
    [
        (1024, 1000, ("band", 8, 1000)),  # ImageNet: 125 bands of 8 target rows, one a block, one wave
        (848, 1000, ("band", 8, 1000)),  # ImageNet's last batch
        (2_097_152, 20, ("split", 132, 1)),  # a Cityscapes image: sqrt(8n) / C = 204 blocks, one an SM
        (1024, 20, ("split", 1, 1)),  # two rows a cell: one block holds the whole table
        (799, 20, ("band", 1, 20)),  # fewer: 20 one-row bands
        (16_384, 20, ("split", 1, 1)),  # two blocks of 8,192 rows lose to one
        (32_768, 20, ("split", 4, 1)),  # four: a block a 8,192 rows
        (262_144, 20, ("split", 32, 1)),
        (4096, 64, ("band", 1, 64)),
        (16_384, 64, ("split", 1, 1)),
        (2_097_152, 64, ("split", 64, 1)),  # sqrt(8n) / C
        (65_536, 240, ("band", 2, 240)),  # fewer than two rows a cell
        (2_097_152, 240, ("split", 17, 1)),  # the last block sums 17 tables of 57,600 cells
        (2_097_152, 241, ("split", 16, 1)),  # the widest table that fits a block's 227 KB
        (2_097_152, 242, ("band", 2, 242)),
        (8_650_752, 2, ("split", 132, 1)),  # at most one block an SM
        (1, 58_112, ("band", 1, 58_106)),  # a row of cells fills shared memory: tiles of one row by 58,106
        (1, 1, ("band", 1, 1)),
    ],
)
def test_confusion_plan_picks_bands_or_a_split_table(n, c, want):
    assert confusion_plan(n, c, *H100) == want
    branch, a, b = want
    shared = band_shared_bytes(a, b) if branch == "band" else split_shared_bytes(c)
    assert shared <= H100[1]


@pytest.mark.parametrize("c", [1, 2, 20, 132, 133, 241, 242, 1000, 3001, 58_110, 58_111, 58_112, 100_000])
def test_confusion_band_tiles_cover_the_matrix_within_shared_memory(c):
    branch, rows, cols = confusion_plan(0, c, *H100)  # no rows: always the band
    assert branch == "band" and band_shared_bytes(rows, cols) <= H100[1]
    assert cols == c or rows == 1
    # at most one tile an SM, unless a taller band would not fit
    assert -(-c // rows) * -(-c // cols) <= H100[0] or band_shared_bytes(rows + 1, cols) > H100[1]


@pytest.mark.parametrize(
    "plan,want",
    [(("band", 8, 1000), "band"), (("split", 1, 1), "split"), (("split", 102, 1), "split, 102 blocks")],
)
def test_confusion_launches_are_named_by_branch_and_blocks(plan, want):
    assert confusion_branch_name(*plan) == want


@pytest.mark.parametrize(
    "n,c,want",
    [
        (1024, 1000, ("block", 1, 1024)),  # ImageNet: one launch, no zeroed output
        (848, 1000, ("block", 1, 1024)),  # ImageNet's last batch
        (1024, 128, ("block", 1, 1024)),  # bench.py's headline shape
        (1, 2, ("block", 1, 1024)),
        (6144, 1000, ("block", 1, 1024)),  # the one-block limit
        (6145, 1000, ("shared", 25, 256)),  # one more row: the multi-block branch and its zeroed output
        (100_000, 1000, ("shared", 264, 256)),  # at most two blocks an SM
        (1024, 19370, ("block", 1, 1024)),  # 3C ints: 232,440 bytes fit
        (6145, 19370, ("shared", 25, 256)),
        (1024, 19371, ("global", 4, 256)),  # 232,452 bytes do not
        (1024, 20000, ("global", 4, 256)),  # chip_smoke.py's widest
        (0, 5, ("block", 1, 1024)),
    ],
)
def test_stat_scores_plan_takes_one_block_for_a_batch(n, c, want):
    assert stat_scores_plan(n, c, H100[1]) == want


@pytest.mark.parametrize(
    "n,c,t,want",
    [
        (1024, 1000, 100, ("hist", 1, False)),  # ImageNet: 125 tiles of 8 classes, a block each
        (848, 1000, 100, ("hist", 1, False)),
        (1024, 80, 100, ("hist", 1, False)),  # COCO: one pass of rows a block, so no cluster
        (568, 80, 100, ("hist", 1, False)),
        (1, 1, 1, ("hist", 1, False)),
        (1025, 80, 100, ("hist", 2, False)),  # past one pass: clusters split the rows of COCO's 10 tiles
        (4096, 80, 100, ("hist", 4, False)),
        (65535, 80, 100, ("hist", 8, False)),  # the most rows of the packed 16-bit counters
        (65536, 80, 100, ("hist", 8, True)),  # one more: two 32-bit planes
        (4096, 528, 100, ("hist", 2, False)),  # 66 tiles: two blocks each fill the 132 SMs
        (4096, 536, 100, ("hist", 1, False)),  # 67 tiles: a second block would run in a second wave
        (65536, 1000, 100, ("hist", 1, True)),
        (1_000_000, 1000, 100, ("hist", 1, True)),
        (1024, 80, 1024, ("hist", 1, False)),  # the threshold limit: one a thread when ranking
        (1024, 80, 1025, ("compare", 1, False)),
        (65536, 80, 844, ("hist", 8, True)),  # the wide histogram's shared-memory limit
        (65536, 80, 845, ("compare", 1, False)),
    ],
)
def test_binned_plan_bins_in_one_launch_up_to_its_limits(n, c, t, want):
    assert binned_plan(n, c, t, *H100) == want


@pytest.mark.parametrize(
    "branch,cluster,wide,want",
    [("hist", 1, False, "hist"), ("hist", 4, False, "hist, clusters of 4"), ("hist", 1, True, "hist, wide"),
     ("hist", 8, True, "hist, clusters of 8, wide"), ("compare", 1, False, "compare")],
)
def test_binned_launches_are_named_by_branch_cluster_and_counters(branch, cluster, wide, want):
    assert branch_name(branch, cluster, wide) == want


def test_binned_hist_limits_follow_the_shared_memory():
    # 100 composites and indices, a 127-node tree, 4 copies x 8 classes x 101 bins, 8 classes x 4 chunk totals
    assert hist_shared_bytes(100, False) == 12 * 100 + 4 * 127 + 4 * 4 * 8 * 101 + 4 * 8 * 4
    assert hist_shared_bytes(100, True) == hist_shared_bytes(100, False) + 4 * 4 * 8 * 101 + 4 * 8 * 4
    assert hist_max_thresholds(False, H100[1]) == 1024 and hist_max_thresholds(True, H100[1]) == 844
    assert hist_shared_bytes(844, True) <= H100[1] < hist_shared_bytes(845, True)
    assert hist_max_thresholds(False, 48 * 1024) < 1024


# ------------------------------------------------------------------ build
def _fake_nvcc(tmp_path, exit_code):
    """A stand-in compiler that writes its ``-o`` file (or fails)."""
    script = tmp_path / "bin" / "nvcc"
    script.parent.mkdir()
    body = f"#!{sys.executable}\nimport sys\nargs = sys.argv[1:]\n"
    if exit_code:
        body += f"print('error: bad source')\nsys.exit({exit_code})\n"
    else:
        body += "open(args[args.index('-o') + 1], 'w').write(' '.join(args))\n"
    script.write_text(body)
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return script


@pytest.fixture
def fake_csrc(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text("// a\n")
    (csrc / "b.cu").write_text("// b\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    return csrc


def test_build_compiles_each_source_once_with_the_hopper_flags(fake_csrc, tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(_fake_nvcc(tmp_path, 0).parent) + os.pathsep + os.environ["PATH"])
    paths = _build.build(["a", "b"])
    assert set(paths) == {"a", "b"}
    for name, path in paths.items():
        cmdline = path.read_text()
        assert "arch=compute_90a,code=sm_90a" in cmdline and "-shared" in cmdline
        assert cmdline.endswith(f"{name}.cu")
    mtime = paths["a"].stat().st_mtime_ns
    assert _build.build(["a"])["a"].stat().st_mtime_ns == mtime  # cached: not rebuilt
    assert sorted(p.name for p in (tmp_path / "_build").iterdir()) == sorted(p.name for p in paths.values())


def test_build_key_follows_the_source(fake_csrc):
    before = _build.library_path("a")
    (fake_csrc / "a.cu").write_text("// a, edited\n")
    assert _build.library_path("a") != before
    assert _build.library_path("b") != _build.library_path("a")


def test_build_failure_raises_with_the_compiler_output(fake_csrc, tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(_fake_nvcc(tmp_path, 2).parent) + os.pathsep + os.environ["PATH"])
    with pytest.raises(RuntimeError, match="error: bad source"):
        _build.build(["a"])
    assert not any((tmp_path / "_build").iterdir())


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.os, "access", lambda *_: False)
    with pytest.raises(RuntimeError, match="nvcc was not found"):
        _build.nvcc()


def test_the_repo_ships_both_kernel_sources():
    for name in _build.SOURCES:
        source = (_build.CSRC / f"{name}.cu").read_text()
        assert 'extern "C" int' in source and "__global__" in source and "Replaces the TPU kernel" in source
