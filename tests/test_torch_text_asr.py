"""The port's edit-distance core and ASR error rates held against the JAX package on the CPU.

Built from the cases of ``tests/text/test_native_edit_distance.py``,
``test_text.py`` and ``test_text_matrix.py``: the same seeded numpy corpora
go through ``metrics_tpu`` and ``metrics_tpu_torch``, functional and module.

* The core: the port builds its own copy of ``edit_distance.cpp``, byte for
  byte the JAX package's, and every entry point gives the JAX package's
  answers; the C++ Levenshtein equals the two-row Python DP (the plain
  version) over a ``hypothesis`` fuzz.
* WER, CER, MER, WIL and WIP: bit-equal, counts, states and rates. Both
  packages round each update's counts to float32 and add in float32.
* Checkpoints JAX -> port -> JAX mid-corpus, the totals just under 2**24
  included, and a world-2 sync over two rank threads: bit-equal.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import metrics_tpu as J
import metrics_tpu.functional as jF
import metrics_tpu_torch as M
import metrics_tpu_torch.functional as tF
from metrics_tpu import native as jax_native
from metrics_tpu.dispatch import FastDispatchUnsupported as JaxUnsupported
from metrics_tpu.functional.text import helper as jax_helper
from metrics_tpu_torch import native
from metrics_tpu_torch.dispatch import FastDispatchUnsupported
from metrics_tpu_torch.functional.text import helper
from metrics_tpu_torch.interop import load_jax_state_dict, to_jax_state_dict
from tests.test_torch_image_paths import JaxPair, TorchPair, run_ranks
from tests.text.test_text_matrix import CORPUS_PREDS, CORPUS_TARGETS, _corpus_counts

PREDS = ["this is the prediction", "there is an other sample"]
TARGETS = ["this is the reference", "there is another one"]
RATES = ["word_error_rate", "char_error_rate", "match_error_rate", "word_information_lost",
         "word_information_preserved"]
MODULES = ["WordErrorRate", "CharErrorRate", "MatchErrorRate", "WordInfoLost", "WordInfoPreserved"]
# the recorded values of the JAX package's doctests (and its reference's)
RECORDED = {"word_error_rate": 0.5, "char_error_rate": 0.3415, "match_error_rate": 0.4444,
            "word_information_lost": 0.6528, "word_information_preserved": 0.3472}
WORDS = ["THE", "A", "OF", "AND", "TO", "HE", "WAS", "IN", "HIS", "THAT", "IT", "HAD", "I'M", "DON'T", "MISTER"]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bits(t, j):
    """Equal values, dtypes and shapes."""
    got, want = _np(t), np.asarray(j)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


def _same_state(tm, jm):
    for key in tm._defaults:
        _bits(getattr(tm, key), getattr(jm, key))


def _corpus(seed, n, err=0.2):
    """``n`` LibriSpeech-like utterances (uppercase words with apostrophes)
    and hypotheses with substitutions, deletions and insertions."""
    rng = np.random.RandomState(seed)
    refs, hyps = [], []
    for _ in range(n):
        ref = list(rng.choice(WORDS, rng.randint(0, 14)))
        hyp = []
        for w in ref:
            r = rng.rand()
            if r < err / 3:
                hyp.append(rng.choice(WORDS))
            elif r < 2 * err / 3:
                continue
            else:
                hyp.append(w)
            if rng.rand() < err / 3:
                hyp.append(rng.choice(WORDS))
        refs.append(" ".join(ref))
        hyps.append(" ".join(hyp))
    return hyps, refs


# ------------------------------------------------------------------ the core
def test_core_source_is_the_jax_packages_file():
    assert native._SRC.read_bytes() == open(jax_native._SRC, "rb").read()
    assert native.library_path().parent == native.BUILD_DIR
    assert native.BUILD_DIR.name == "_build" and native.BUILD_DIR.parent.name == "metrics_tpu_torch"


def test_a_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    broken = tmp_path / "edit_distance.cpp"
    broken.write_text('extern "C" int tm_levenshtein( {\n')
    monkeypatch.setattr(native, "_SRC", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on edit_distance.cpp") as err:
        native.load()
    assert "error" in str(err.value)
    assert not list((tmp_path / "_build").iterdir())  # no half-written library is left
    with pytest.raises(RuntimeError):  # and no silent fallback on the next call
        native.levenshtein_ids([1], [2])


def test_a_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ was not found"):
        native.load()


@pytest.mark.parametrize("a, b, expected", [
    ([], [], 0),
    (["x"], [], 1),
    ([], ["x", "y"], 2),
    ("kitten", "sitting", 3),
    ("flaw", "lawn", 2),
    (["the", "cat", "sat"], ["the", "cat", "sat"], 0),
    (["a", "b", "c"], ["c", "b", "a"], 2),
])
def test_known_distances(a, b, expected):
    assert helper._edit_distance(list(a), list(b)) == expected == jax_helper._edit_distance(list(a), list(b))
    assert helper._edit_distance_py(list(a), list(b)) == expected


def test_core_equals_the_python_dp_and_the_jax_core_on_random_pairs():
    rng = np.random.RandomState(0)
    for _ in range(50):
        n, m = rng.randint(0, 40, 2)
        a = [f"t{v}" for v in rng.randint(0, 10, n)]
        b = [f"t{v}" for v in rng.randint(0, 10, m)]
        ids_a, ids_b = helper._tokens_to_ids(a, b)
        for x, y in zip((ids_a, ids_b), jax_helper._tokens_to_ids(a, b)):
            _bits(x, y)
        assert native.levenshtein_ids(ids_a, ids_b) == helper._edit_distance_py(a, b) == \
            jax_native.levenshtein_ids(ids_a, ids_b)


@settings(max_examples=200, deadline=None)
@given(st.lists(st.integers(0, 6), max_size=30), st.lists(st.integers(0, 6), max_size=30))
def test_core_levenshtein_equals_the_python_dp(a, b):
    assert native.levenshtein_ids(np.asarray(a, np.int32), np.asarray(b, np.int32)) == helper._edit_distance_py(a, b)
    assert native.levenshtein_batch_ids([np.asarray(a, np.int32)], [np.asarray(b, np.int32)]).tolist() == \
        [helper._edit_distance_py(a, b)]


def test_batch_equals_single_calls_and_the_jax_batch():
    rng = np.random.RandomState(1)
    a_seqs = [rng.randint(0, 8, rng.randint(0, 25)).astype(np.int32) for _ in range(20)]
    b_seqs = [rng.randint(0, 8, rng.randint(0, 25)).astype(np.int32) for _ in range(20)]
    batch = native.levenshtein_batch_ids(a_seqs, b_seqs)
    assert batch.dtype == np.int64
    np.testing.assert_array_equal(batch, [native.levenshtein_ids(a, b) for a, b in zip(a_seqs, b_seqs)])
    np.testing.assert_array_equal(batch, jax_native.levenshtein_batch_ids(a_seqs, b_seqs))
    assert native.levenshtein_batch_ids([], []).shape == (0,)
    with pytest.raises(ValueError, match="as many second sequences"):
        native.levenshtein_batch_ids(a_seqs, b_seqs[:3])


def test_unhashable_tokens_take_the_equality_dp():
    assert helper._edit_distance([[1, 2]], [[1, 2]]) == 0 == jax_helper._edit_distance([[1, 2]], [[1, 2]])
    assert helper._edit_distances([([[1]], [[2]]), ([[3]], [[3]])]) == [1, 0]
    pairs = [(list("kitten"), list("sitting")), ([], list("ab")), (list("same"), list("same"))]
    assert helper._edit_distances(pairs) == [helper._edit_distance(a, b) for a, b in pairs] == [3, 2, 0]
    assert helper._edit_distances([]) == []


def test_lcs_entry_points_equal_the_jax_core():
    rng = np.random.RandomState(2)
    for _ in range(30):
        p = rng.randint(0, 6, rng.randint(0, 20)).astype(np.int32)
        r = rng.randint(0, 6, rng.randint(0, 20)).astype(np.int32)
        assert native.lcs_ids(p, r) == jax_native.lcs_ids(p, r)
        got, want = np.zeros(len(r), np.uint8), np.zeros(len(r), np.uint8)
        native.lcs_union_mark(p, r, got)
        jax_native.lcs_union_mark(p, r, want)
        np.testing.assert_array_equal(got, want)
        assert int(got.sum()) == native.lcs_ids(p, r)
    with pytest.raises(ValueError, match="contiguous uint8"):
        native.lcs_union_mark(p, r, np.zeros(len(r) + 1, np.uint8))


def test_coco_match_equals_the_jax_core():
    rng = np.random.RandomState(3)
    thresholds = np.linspace(0.5, 0.95, 10)
    for _ in range(10):
        n_det, n_gt = rng.randint(0, 8, 2)
        ious = rng.rand(n_det, n_gt)
        ignore = rng.rand(n_gt) < 0.3
        ignore = np.sort(ignore)  # ignored last
        for g, w in zip(native.coco_match(ious, ignore, thresholds), jax_native.coco_match(ious, ignore, thresholds)):
            assert g.dtype == bool and g.shape == (10, n_det)
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="n_gt ignore flags"):
        native.coco_match(np.zeros((2, 3)), np.zeros(2, bool), thresholds)


# ------------------------------------------------------------ the functionals
@pytest.mark.parametrize("name", RATES)
def test_recorded_values(name):
    got = getattr(tF, name)(PREDS, TARGETS, device="cpu")
    assert got.dtype == torch.float32 and got.shape == ()
    assert round(float(got), 4) == RECORDED[name]


@pytest.mark.parametrize("name", RATES)
@pytest.mark.parametrize("corpus", ["matrix", "seeded", "single string", "empty hypotheses"])
def test_rates_are_jax_bits(name, corpus):
    if corpus == "matrix":
        preds, target = CORPUS_PREDS, CORPUS_TARGETS
    elif corpus == "seeded":
        preds, target = _corpus(10, 64)
    elif corpus == "single string":
        preds, target = PREDS[0], TARGETS[0]
    else:
        preds, target = ["", "A B"], ["THE CAT", "A B C"]
    _bits(getattr(tF, name)(preds, target, device="cpu"), getattr(jF, name)(preds, target))


def test_rates_equal_the_alignment_oracle():
    dist, total_max, n_ref, n_hyp = _corpus_counts(str.split)
    cdist, _, c_ref, _ = _corpus_counts(list)
    hits = total_max - dist
    want = {"word_error_rate": dist / n_ref, "char_error_rate": cdist / c_ref, "match_error_rate": dist / total_max,
            "word_information_preserved": (hits / n_ref) * (hits / n_hyp)}
    want["word_information_lost"] = 1 - want["word_information_preserved"]
    for name, value in want.items():
        np.testing.assert_allclose(float(getattr(tF, name)(CORPUS_PREDS, CORPUS_TARGETS, device="cpu")), value,
                                   rtol=1e-6)


# ------------------------------------------------------------------ modules
def _batches(seed=20, n=4, size=8):
    hyps, refs = _corpus(seed, n * size)
    return [(hyps[i:i + size], refs[i:i + size]) for i in range(0, n * size, size)]


@pytest.mark.parametrize("name", MODULES)
def test_module_update_forward_compute_reset_are_jax_bits(name):
    jm, tm = getattr(J, name)(), getattr(M, name)(device="cpu")
    (p0, t0), (p1, t1), (p2, t2), _ = _batches()
    jm.update(p0, t0)
    tm.update(p0, t0)
    _same_state(tm, jm)
    _bits(tm(p1, t1), jm(p1, t1))
    _same_state(tm, jm)
    jm.update(p2, t2)
    tm.update(p2, t2)
    _bits(tm.compute(), jm.compute())
    tm.reset()
    assert all(float(getattr(tm, k)) == 0.0 for k in tm._defaults)
    assert all(getattr(tm, k).dtype == torch.float32 for k in tm._defaults)


@pytest.mark.parametrize("name", MODULES)
def test_module_accumulation_equals_the_functional(name):
    fn = getattr(tF, RATES[MODULES.index(name)])
    m = getattr(M, name)(device="cpu")
    for i in range(len(CORPUS_PREDS)):
        m.update(CORPUS_PREDS[i:i + 1], CORPUS_TARGETS[i:i + 1])
    _bits(m.compute(), fn(CORPUS_PREDS, CORPUS_TARGETS, device="cpu"))


@pytest.mark.parametrize("name", MODULES)
def test_module_checkpoints_cross_between_jax_and_port(name):
    """JAX -> port -> JAX mid-corpus, then one more batch in all three: the same bits."""
    jm, tm, back = getattr(J, name)(), getattr(M, name)(device="cpu"), getattr(J, name)()
    for m in (jm, tm, back):
        m.persistent(True)
    (p0, t0), (p1, t1) = _batches(seed=21, n=2)
    jm.update(p0, t0)
    load_jax_state_dict(tm, jm.state_dict())
    _same_state(tm, jm)
    back.load_state_dict(to_jax_state_dict(tm))
    for m in (jm, back):
        m.update(p1, t1)
    tm.update(p1, t1)
    _same_state(tm, jm)
    _same_state(tm, back)
    _bits(tm.compute(), jm.compute())


@pytest.mark.parametrize("name", MODULES)
@pytest.mark.parametrize("start", [2**24 - 5, 2**24 - 1, 2**24, 2**24 + 1, 2**25 - 3])
def test_totals_near_2_to_the_24_are_jax_bits(name, start):
    """A JAX state whose totals sit near 2**24 (where float32 stops holding
    every integer), loaded into the port, then the same batches in both: the
    same bits. Each update rounds its counts to float32 and adds once."""
    jm, tm = getattr(J, name)(), getattr(M, name)(device="cpu")
    jm.persistent(True)
    for key in jm._defaults:
        setattr(jm, key, jnp.asarray(float(start)))
    load_jax_state_dict(tm, jm.state_dict())
    for p, t in _batches(seed=22, n=3):
        jm.update(p, t)
        tm.update(p, t)
        _same_state(tm, jm)
    _bits(tm.compute(), jm.compute())


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_float32_counts_stop_counting_past_2_to_the_24(pkg):
    """The states are float32 sums, as the JAX package's: past 2**24 an odd
    count is lost to rounding (ROADMAP.md Queue C records it; the port keeps
    float32 so that checkpoints cross bit-equal)."""
    m = J.WordErrorRate() if pkg == "jax" else M.WordErrorRate(device="cpu")
    m.total = jnp.asarray(float(2**24)) if pkg == "jax" else torch.tensor(float(2**24))
    m.update(["A"], ["A"])  # one reference word
    assert float(m.total) == 2**24
    m.update(["A B"], ["A B"])  # two words: exact again
    assert float(m.total) == 2**24 + 2


def test_host_only_warns_runs_eagerly_and_the_engine_refuses_it():
    assert all(getattr(M, name).host_only is True for name in MODULES)
    with pytest.warns(UserWarning, match="host_only") as jax_warned:
        jm = J.WordErrorRate(jit_update=True)
    with pytest.warns(UserWarning, match="host_only") as port_warned:
        tm = M.WordErrorRate(jit_update=True, device="cpu")
    assert [str(w.message) for w in port_warned] == [str(w.message) for w in jax_warned]
    jm.update(PREDS, TARGETS)
    tm.update(PREDS, TARGETS)
    _same_state(tm, jm)
    assert tm._dispatcher is None and tm.dispatch_stats["dispatches"] == 1
    with pytest.raises(JaxUnsupported) as jax_err:
        jm._make_dispatcher()._prepare_call((), (), ())
    with pytest.raises(FastDispatchUnsupported) as port_err:
        tm._make_dispatcher().update({}, (), (PREDS, TARGETS), {})
    assert str(port_err.value) == str(jax_err.value)


def test_collection_of_the_five_runs_eagerly_and_equals_each_alone():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        coll = M.MetricCollection({n: getattr(M, n)(device="cpu") for n in MODULES}, fused_update=True)
        jcoll = J.MetricCollection({n: getattr(J, n)() for n in MODULES})
    alone = {n: getattr(M, n)(device="cpu") for n in MODULES}
    for p, t in _batches(seed=23):
        coll.update(p, t)
        jcoll.update(p, t)
        for m in alone.values():
            m.update(p, t)
    got, want = coll.compute(), jcoll.compute()
    for n in MODULES:
        _bits(got[n], alone[n].compute())
        _bits(got[n], want[n])


@pytest.mark.parametrize("name", ["WordErrorRate", "WordInfoLost"])
def test_sync_on_two_ranks_equals_jax(name):
    """Each rank its own batches; ``compute`` syncs through the env: the
    same states and values as the JAX package's, and as one process over both
    ranks' batches."""
    data = [_batches(seed=30 + r, n=2 + r) for r in range(2)]

    def make(pkg):
        def fn(rank, env):
            m = getattr(J, name)() if pkg is J else getattr(M, name)(device="cpu")
            m._sync_env = env
            for p, t in data[rank]:
                m.update(p, t)
            value = m.compute()
            m.sync(env=env)
            return _np(value), {k: _np(getattr(m, k)) for k in m._defaults}, dict(m.sync_stats)

        return fn

    touts, jouts = run_ranks(make(M), TorchPair), run_ranks(make(J), JaxPair)
    single = getattr(M, name)(device="cpu")
    for p, t in data[0] + data[1]:
        single.update(p, t)
    for (tv, ts, tstats), (jv, js, jstats) in zip(touts, jouts):
        _bits(tv, jv)
        _bits(tv, single.compute())
        for key in js:
            _bits(ts[key], js[key])
        assert tstats == jstats
