"""The port's sentence splitter and ROUGE held against the JAX package on the CPU.

The same seeded numpy corpora (news-style sentences with abbreviations,
initials and numbers) go through ``metrics_tpu`` and ``metrics_tpu_torch``,
functional and module. Tolerances:

* exact: the splitter's sentences, every sample's precision, recall and
  F-measure (the port's Python float rounded to float32 once, against the
  JAX package's ``jnp.asarray`` of it), the modules' list states;
* rtol 1e-6: the float32 means over samples (a sum in another library).

The JAX package's rougeLsum would try to download punkt's data: its
``_punkt_usable`` is set to False here, as ``tests/parity/test_reference_oracle.py``
does, and so is the port's, so both split with the vendored splitter. Where
the JAX package raises, the port raises the same type with the same message.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import metrics_tpu as J
import metrics_tpu.functional as jF
import metrics_tpu_torch as M
import metrics_tpu_torch.functional as tF
from metrics_tpu.functional.text import rouge as jax_rouge
from metrics_tpu.functional.text.sentence_split import split_sentences as jax_split
from metrics_tpu.text import rouge as jax_rouge_module
from metrics_tpu_torch.functional.text import rouge as port_rouge
from metrics_tpu_torch.functional.text.sentence_split import split_sentences
from metrics_tpu_torch.interop import load_jax_state_dict, to_jax_state_dict
from metrics_tpu_torch.text import rouge as port_rouge_module
from tests.test_torch_image_paths import JaxPair, TorchPair, run_ranks

RTOL = 1e-6
GOLDENS = json.loads((Path(__file__).parent / "text" / "punkt_goldens.json").read_text())["cases"]
WORDS = ["the", "council", "said", "on", "tuesday", "market", "shares", "rose", "fell", "by", "3.5", "percent",
         "government", "minister", "report", "police", "city", "new", "plan", "after", "year", "1,000", "people"]
OPENERS = ["Mr.", "Dr.", "The", "U.S.", "J. K.", "Officials", "In 2019", "Sen.", "No. 4"]
ALL_KEYS = tuple(jax_rouge.ALLOWED_ROUGE_KEYS)


@pytest.fixture(autouse=True)
def _vendored_splitter(monkeypatch):
    monkeypatch.setattr(jax_rouge, "_punkt_usable", lambda: False)
    monkeypatch.setattr(port_rouge, "_punkt_usable", lambda: False)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bits(t, j):
    got, want = _np(t), np.asarray(j)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


def _close(t, j):
    got, want = _np(t), np.asarray(j)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def _sentence(rng):
    words = list(rng.choice(WORDS, rng.randint(3, 12)))
    return f"{rng.choice(OPENERS)} {' '.join(words)}{rng.choice(['.', '.', '!', '?'])}"


def _summary(rng, n_sents):
    return " ".join(_sentence(rng) for _ in range(n_sents))


def _corpus(seed, n, refs=1):
    """``n`` summaries of 1-4 sentences, each with ``refs`` references: the
    first reference edits the summary (word swaps and drops, a sentence
    added), the others are fresh; every seventh pair has an empty side."""
    rng = np.random.RandomState(seed)
    preds, targets = [], []
    for i in range(n):
        pred = _summary(rng, rng.randint(1, 5))
        first = " ".join(w if rng.rand() > 0.2 else rng.choice(WORDS) for w in pred.split() if rng.rand() > 0.1)
        first = f"{first} {_sentence(rng)}" if rng.rand() < 0.5 else first
        target = [first] + [_summary(rng, rng.randint(1, 4)) for _ in range(refs - 1)]
        if i % 7 == 3:
            pred = ""
        elif i % 7 == 5:
            target[0] = ""
        preds.append(pred)
        targets.append(target)
    return preds, targets


# ------------------------------------------------------------------ splitter
@pytest.mark.parametrize("case", GOLDENS, ids=lambda c: c["text"][:40])
def test_splitter_is_jax_on_the_punkt_goldens(case):
    assert split_sentences(case["text"]) == jax_split(case["text"]) == case["sentences"]


def test_splitter_is_jax_on_a_seeded_corpus():
    preds, targets = _corpus(0, 200, refs=2)
    for text in preds + [t for ts in targets for t in ts]:
        assert split_sentences(text) == jax_split(text), text


# ---------------------------------------------------------------- functional
def _per_sample(preds, targets, keys, accumulate, **kwargs):
    """Both packages' ``_rouge_score_update`` on the same corpus: every sample's three scores, bit for bit."""
    values = [jax_rouge.ALLOWED_ROUGE_KEYS[k] for k in keys]
    want = jax_rouge._rouge_score_update(preds, targets, values, accumulate, **kwargs)
    got = port_rouge._rouge_score_update(preds, targets, values, accumulate, **kwargs)
    for key in values:
        assert len(got[key]) == len(want[key])
        for g, w in zip(got[key], want[key]):
            for tp in ("fmeasure", "precision", "recall"):
                _bits(torch.tensor(g[tp], dtype=torch.float32), w[tp])


def _functional(preds, targets, **kwargs):
    got = tF.rouge_score(preds, targets, device="cpu", **kwargs)
    want = jF.rouge_score(preds, targets, **kwargs)
    assert list(got) == list(want)
    for key in want:
        _close(got[key], want[key])
    return got


@pytest.mark.parametrize("key", ALL_KEYS)
@pytest.mark.parametrize("accumulate", ["best", "avg"])
def test_every_key_is_jax(key, accumulate):
    preds, targets = _corpus(1, 40, refs=3)
    _per_sample(preds, targets, (key,), accumulate)
    _functional(preds, targets, rouge_keys=key, accumulate=accumulate)


@pytest.mark.parametrize("refs", [1, 2, 4])
def test_default_keys_multi_reference_and_empty_strings_are_jax(refs):
    preds, targets = _corpus(2 + refs, 30, refs=refs)
    _per_sample(preds, targets, ("rouge1", "rouge2", "rougeL", "rougeLsum"), "best")
    _functional(preds, targets)
    _functional(["", "a b"], [["", "x"], [""]])
    _functional("My name is John", "Is your name John")
    _functional(["the cat"], ["the cat"])


@pytest.mark.parametrize("scrub", [False, True])
def test_pegasus_markers_both_ways_are_jax(scrub):
    preds = ["First sentence here.<n>Second sentence follows. <n> Third one ends.", "One line.<n>Two lines."]
    targets = [["First sentence.<n>Second one follows. Third ends."], ["One line. <n>Two lines here."]]
    _per_sample(preds, targets, ("rougeLsum",), "best", scrub_pegasus_markers=scrub)
    out = _functional(preds, targets, rouge_keys="rougeLsum", scrub_pegasus_markers=scrub)
    other = tF.rouge_score(preds, targets, rouge_keys="rougeLsum", scrub_pegasus_markers=not scrub, device="cpu")
    assert float(out["rougeLsum_fmeasure"]) != float(other["rougeLsum_fmeasure"])


def test_custom_tokenizer_with_unhashable_tokens_and_normalizer_are_jax():
    """A tokenizer of one-element lists (``==`` only) takes ROUGE-L's Python
    DP, and ROUGE-N's n-gram counts raise ``TypeError`` in both packages; a
    hashable tokenizer and a normalizer before it run every key."""
    preds, targets = _corpus(7, 20, refs=2)

    def unhashable(text):
        return [[w] for w in text.split()]

    def tokenizer(text):
        return text.split()

    def normalizer(text):
        return text.lower().replace(".", "")

    for kwargs in ({"tokenizer": unhashable}, {"tokenizer": unhashable, "normalizer": normalizer}):
        _per_sample(preds, targets, ("rougeL", "rougeLsum"), "best", **kwargs)
        _functional(preds, targets, rouge_keys=("rougeL", "rougeLsum"), **kwargs)
        _functional(preds, targets, rouge_keys=("rougeL",), accumulate="avg", **kwargs)
        with pytest.raises(TypeError, match="unhashable"):
            jF.rouge_score(preds, targets, rouge_keys="rouge1", **kwargs)
        with pytest.raises(TypeError, match="unhashable"):
            tF.rouge_score(preds, targets, rouge_keys="rouge1", device="cpu", **kwargs)
    for kwargs in ({"tokenizer": tokenizer}, {"normalizer": normalizer}, {"tokenizer": tokenizer, "normalizer": normalizer}):
        _per_sample(preds, targets, ALL_KEYS, "best", **kwargs)
        _functional(preds, targets, rouge_keys=ALL_KEYS, **kwargs)


def test_lcs_cap_path_is_jax_and_the_cores(monkeypatch):
    """A summary past ``_NATIVE_LCS_MAX_CELLS`` takes the Python union LCS in
    both packages: the same scores as each other and as the core's."""
    preds, targets = _corpus(8, 20, refs=2)
    with_core = tF.rouge_score(preds, targets, rouge_keys="rougeLsum", device="cpu")
    monkeypatch.setattr(jax_rouge, "_NATIVE_LCS_MAX_CELLS", 16)
    monkeypatch.setattr(port_rouge, "_NATIVE_LCS_MAX_CELLS", 16)
    calls = []
    union = port_rouge._union_lcs_py
    monkeypatch.setattr(port_rouge, "_union_lcs_py", lambda *a: calls.append(1) or union(*a))
    _per_sample(preds, targets, ("rougeLsum",), "best")
    capped = _functional(preds, targets, rouge_keys="rougeLsum")
    assert calls
    for key in capped:
        _bits(capped[key], with_core[key])


def test_lcs_core_equals_the_python_dp():
    rng = np.random.RandomState(9)
    for _ in range(200):
        a = [str(x) for x in rng.randint(0, rng.randint(2, 12), rng.randint(0, 30))]
        b = [str(x) for x in rng.randint(0, rng.randint(2, 12), rng.randint(0, 30))]
        assert port_rouge._lcs(a, b) == port_rouge._lcs_py(a, b) == jax_rouge._lcs(a, b)
        sents = [a[: len(a) // 2], a[len(a) // 2:]]
        assert port_rouge._rouge_lsum_score(sents, [b]) == jax_rouge._rouge_lsum_score(sents, [b])


def test_stemmer_is_jax():
    pytest.importorskip("nltk")
    preds, targets = _corpus(10, 30, refs=2)
    preds = [p.replace("rose", "rising").replace("said", "says") for p in preds]
    _per_sample(preds, targets, ALL_KEYS, "best", stemmer=_porter_stemmer())
    _functional(preds, targets, use_stemmer=True, rouge_keys=ALL_KEYS)
    jm, tm = J.ROUGEScore(use_stemmer=True), M.ROUGEScore(use_stemmer=True, device="cpu")
    jm.update(preds, targets)
    tm.update(preds, targets)
    _same_state(tm, jm)


def _porter_stemmer():
    import nltk

    return nltk.stem.porter.PorterStemmer()


def test_errors_are_jax():
    for kwargs in ({"rouge_keys": "rouge10"}, {"accumulate": "mean"}):
        with pytest.raises(ValueError) as jax_err:
            jF.rouge_score("a", "a", **kwargs)
        with pytest.raises(ValueError) as port_err:
            tF.rouge_score("a", "a", device="cpu", **kwargs)
        assert str(port_err.value) == str(jax_err.value)
        with pytest.raises(ValueError) as jax_err:
            J.ROUGEScore(**kwargs)
        with pytest.raises(ValueError) as port_err:
            M.ROUGEScore(device="cpu", **kwargs)
        assert str(port_err.value) == str(jax_err.value)


# ------------------------------------------------------------------ splitting
def test_the_port_never_downloads_punkt(monkeypatch):
    """The probe asks ``nltk.data.find`` only: where the data is missing, the
    vendored splitter runs and ``nltk.download`` is never called; where it is
    present, ``nltk.sent_tokenize`` splits."""
    nltk = pytest.importorskip("nltk")
    monkeypatch.undo()  # the real probe
    monkeypatch.setattr(nltk, "download", lambda *a, **k: pytest.fail("the port called nltk.download"))

    def missing(name):
        raise LookupError(name)

    monkeypatch.setattr(nltk.data, "find", missing)
    port_rouge._punkt_usable.cache_clear()
    try:
        assert port_rouge._punkt_usable() is False
        text = "Mr. Smith went home. He slept."
        assert port_rouge._add_newline_to_end_of_each_sentence(text) == "\n".join(split_sentences(text))
        tF.rouge_score([text], [[text]], rouge_keys="rougeLsum", device="cpu")

        port_rouge._punkt_usable.cache_clear()
        monkeypatch.setattr(nltk.data, "find", lambda name: name)
        monkeypatch.setattr(nltk, "sent_tokenize", lambda x: ["punkt", "split"])
        assert port_rouge._punkt_usable() is True
        assert port_rouge._add_newline_to_end_of_each_sentence(text) == "punkt\nsplit"
    finally:
        port_rouge._punkt_usable.cache_clear()


# ------------------------------------------------------------------- modules
def _same_state(tm, jm):
    for key in tm._defaults:
        got, want = getattr(tm, key), getattr(jm, key)
        assert isinstance(got, list) and len(got) == len(want), key
        for g, w in zip(got, want):
            _bits(g, w)


def _batches(seed, n=3, size=6, refs=2):
    preds, targets = _corpus(seed, n * size, refs=refs)
    return [(preds[i:i + size], targets[i:i + size]) for i in range(0, n * size, size)]


MODULES = {
    "default": {},
    "avg": {"accumulate": "avg", "rouge_keys": ("rouge1", "rougeL")},
    "all keys": {"rouge_keys": ALL_KEYS},
    "scrub": {"rouge_keys": ("rougeLsum",), "scrub_pegasus_markers": True},
}


@pytest.mark.parametrize("case", MODULES)
def test_module_update_forward_compute_reset_equal_jax(case):
    jm, tm = J.ROUGEScore(**MODULES[case]), M.ROUGEScore(device="cpu", **MODULES[case])
    (p0, t0), (p1, t1), (p2, t2) = _batches(20)
    jm.update(p0, t0)
    tm.update(p0, t0)
    _same_state(tm, jm)
    got, want = tm(p1, t1), jm(p1, t1)
    for key in want:
        _close(got[key], want[key])
    _same_state(tm, jm)
    jm.update(p2, t2)
    tm.update(p2, t2)
    _same_state(tm, jm)
    got, want = tm.compute(), jm.compute()
    assert list(got) == list(want)
    for key in want:
        _close(got[key], want[key])
    tm.reset()
    assert all(getattr(tm, key) == [] for key in tm._defaults)
    for key, value in tm.compute().items():
        _bits(value, np.float32(0.0))


def test_a_batch_is_one_buffer_of_views():
    """An update copies its batch's scores once: every sample's ``(1,)``
    tensor of every state is a view of one float32 buffer."""
    tm = M.ROUGEScore(device="cpu")
    preds, targets = _corpus(21, 8)
    tm.update(preds, targets)
    bases = {v.untyped_storage().data_ptr() for key in tm._defaults for v in getattr(tm, key)}
    assert len(bases) == 1
    assert all(v.shape == (1,) and v.dtype == torch.float32 for key in tm._defaults for v in getattr(tm, key))


def test_module_checkpoints_cross_between_jax_and_port():
    jm, tm, back = J.ROUGEScore(), M.ROUGEScore(device="cpu"), J.ROUGEScore()
    for m in (jm, tm, back):
        m.persistent(True)
    (p0, t0), (p1, t1) = _batches(22, n=2)
    jm.update(p0, t0)
    load_jax_state_dict(tm, jm.state_dict())
    _same_state(tm, jm)
    back.load_state_dict(to_jax_state_dict(tm))
    for m in (jm, back):
        m.update(p1, t1)
    tm.update(p1, t1)
    _same_state(tm, jm)
    _same_state(tm, back)
    for key, value in jm.compute().items():
        _close(tm.compute()[key], value)


def test_sync_on_two_ranks_gives_the_one_process_mean_where_jax_gives_the_samples():
    """A reference fault not copied (ROADMAP.md Queue C): after a sync the
    JAX package's compute returns each key's gathered per-sample array, not
    its mean; the port's returns the mean, the one-process value. The
    gathered states are the JAX package's."""
    data = [_batches(30 + r, n=1 + r) for r in range(2)]

    def make(pkg, kwargs):
        def fn(rank, env):
            m = pkg.ROUGEScore(**kwargs)
            m._sync_env = env
            for p, t in data[rank]:
                m.update(p, t)
            value = {k: _np(v) for k, v in m.compute().items()}
            m.sync(env=env)
            return value, {k: _np(getattr(m, k)) for k in m._defaults}

        return fn

    single = M.ROUGEScore(device="cpu")
    for p, t in data[0] + data[1]:
        single.update(p, t)
    touts, jouts = run_ranks(make(M, {"device": "cpu"}), TorchPair), run_ranks(make(J, {}), JaxPair)
    for (tv, ts), (jv, js) in zip(touts, jouts):
        for key, value in single.compute().items():
            _close(tv[key], _np(value))
            gathered = torch.cat(getattr(single, key))
            _bits(gathered, jv[key])
        for key in js:
            _bits(ts[key], js[key])


def test_constructor_needs_nltk_only_for_the_stemmer(monkeypatch):
    """A reference fault not copied (ROADMAP.md Queue C): without nltk the
    JAX package's ``ROUGEScore()`` raises for its default ``rougeLsum``,
    which its own functional computes without nltk; the port's constructs
    and gives the JAX functional's values, and raises for ``use_stemmer``."""
    monkeypatch.setattr(jax_rouge_module, "_NLTK_AVAILABLE", False)
    monkeypatch.setattr(port_rouge_module, "_NLTK_AVAILABLE", False)
    with pytest.raises(ModuleNotFoundError, match="rougeLsum"):
        J.ROUGEScore()
    preds, targets = _corpus(40, 12, refs=2)
    tm = M.ROUGEScore(device="cpu")
    tm.update(preds, targets)
    want = jF.rouge_score(preds, targets)
    for key, value in tm.compute().items():
        _close(value, want[key])
    with pytest.raises(ModuleNotFoundError, match="Stemmer requires that `nltk` is installed"):
        M.ROUGEScore(use_stemmer=True, device="cpu")


def test_host_only_warns_and_runs_eagerly_like_jax():
    assert M.ROUGEScore.host_only is True
    with pytest.warns(UserWarning, match="host_only") as jax_warned:
        jm = J.ROUGEScore(jit_update=True)
    with pytest.warns(UserWarning, match="host_only") as port_warned:
        tm = M.ROUGEScore(jit_update=True, device="cpu")
    assert [str(w.message) for w in port_warned] == [str(w.message) for w in jax_warned]
    preds, targets = _corpus(41, 6)
    jm.update(preds, targets)
    tm.update(preds, targets)
    _same_state(tm, jm)
    assert tm._dispatcher is None
