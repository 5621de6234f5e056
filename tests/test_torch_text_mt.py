"""The port's translation metrics held against the JAX package on the CPU.

BLEU, SacreBLEU (all five tokenizers), chrF and chrF++, TER and EED, built
from the cases of ``tests/text/test_text.py``, ``test_text_matrix.py``,
``test_chrf_native.py`` and ``test_native_edit_distance.py``: the same seeded
numpy corpora go through ``metrics_tpu`` and ``metrics_tpu_torch``,
functional and module. Tolerances:

* exact: every count state (BLEU's n-gram counts and lengths, chrF's
  per-order sums, TER's totals), the list states' sentence scores, the
  tokenizers' tokens, chrF's core against its ``Counter`` path, TER's core
  against the Python DP;
* rtol 1e-6: the BLEU, chrF, TER and EED scores against the JAX package
  (float32 arithmetic in another library);
* EED's core against the numpy grid: atol 1e-12 (both float64).

Where the JAX package raises, the port raises the same type with the same
message. Checkpoints cross JAX -> port -> JAX mid-corpus, list states
included, and a world-2 sync over two rank threads equals the JAX package's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as J
import metrics_tpu.functional as jF
import metrics_tpu_torch as M
import metrics_tpu_torch.functional as tF
from metrics_tpu.functional.text import sacre_bleu as jax_sacre_bleu
from metrics_tpu.functional.text.sacre_bleu import _SacreBLEUTokenizer as JaxTokenizer
from metrics_tpu_torch import native
from metrics_tpu_torch.functional.text import chrf as port_chrf
from metrics_tpu_torch.functional.text import eed as port_eed
from metrics_tpu_torch.functional.text import sacre_bleu as port_sacre_bleu
from metrics_tpu_torch.functional.text import ter as port_ter
from metrics_tpu_torch.functional.text.helper import _edit_distance_py
from metrics_tpu_torch.functional.text.sacre_bleu import AVAILABLE_TOKENIZERS, _SacreBLEUTokenizer
from metrics_tpu_torch.interop import load_jax_state_dict, to_jax_state_dict
from tests.test_torch_image_paths import JaxPair, TorchPair, run_ranks
from tests.text.test_text_matrix import _TER_PREDS, _TER_TARGETS, CORPUS_PREDS, CORPUS_TARGETS

RTOL = 1e-6
BLEU_PREDS = ["the cat is on the mat", "the fast brown fox jumped"]
BLEU_TARGETS = [
    ["there is a cat on the mat", "a cat is on the mat"],
    ["the quick brown fox jumped over", "a quick brown fox leaped"],
]
ZH_PREDS = ["猫坐在垫子上", "今天天气很好 it is sunny", "会议于3月15日举行。"]
ZH_TARGETS = [["猫坐在垫子上面"], ["今天天气真好 it is sunny"], ["会议在3月15日举行。", "会议于3月15号召开。"]]
VOCAB = ["the", "a", "of", "council", "said", "on", "Tuesday", "3.5", "1,000", "U.S.", "don't", "it's", "(EU)",
         "&amp;", "-", "well-known", "\"quoted\"", "end.", "why?", "yes!", "co-operation", "Mr.", "Ms"]


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


def _leaf(x):
    return [_np(v) for v in x] if isinstance(x, list) else _np(x)


def _same_state(tm, jm):
    for key in tm._defaults:
        got, want = getattr(tm, key), getattr(jm, key)
        if isinstance(want, list):
            assert isinstance(got, list) and len(got) == len(want), key
            for g, w in zip(got, want):
                _bits(g, w)
        else:
            _bits(got, want)


def _corpus(seed, n, refs=1):
    """``n`` segments of WMT-like words with punctuation and numbers, each
    with ``refs`` references: a hypothesis edits the first reference (word
    substitutions, drops, a swap), the others reorder or edit it too."""
    rng = np.random.RandomState(seed)
    preds, targets = [], []
    for _ in range(n):
        ref = list(rng.choice(VOCAB, rng.randint(1, 16)))
        hyp = [w if rng.rand() > 0.2 else rng.choice(VOCAB) for w in ref if rng.rand() > 0.1]
        if len(hyp) > 3 and rng.rand() < 0.5:
            i = rng.randint(0, len(hyp) - 2)
            hyp[i], hyp[i + 2] = hyp[i + 2], hyp[i]
        others = []
        for _ in range(refs - 1):
            other = list(ref)
            rng.shuffle(other[: len(other) // 2])
            others.append(" ".join(w if rng.rand() > 0.15 else rng.choice(VOCAB) for w in other))
        preds.append(" ".join(hyp))
        targets.append([" ".join(ref)] + others)
    return preds, targets


# ----------------------------------------------------------------------- BLEU
@pytest.mark.parametrize("n_gram", [1, 2, 3, 4])
@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("corpus", ["doc", "one ref", "four refs"])
def test_bleu_is_jax(n_gram, smooth, corpus):
    preds, target = {"doc": (BLEU_PREDS, BLEU_TARGETS), "one ref": _corpus(1, 40),
                     "four refs": _corpus(2, 40, refs=4)}[corpus]
    _close(tF.bleu_score(preds, target, n_gram=n_gram, smooth=smooth, device="cpu"),
           jF.bleu_score(preds, target, n_gram=n_gram, smooth=smooth))


def test_bleu_recorded_value_and_edges():
    assert round(float(tF.bleu_score(["the cat is on the mat"], [BLEU_TARGETS[0]], device="cpu")), 4) == 0.7598
    assert float(tF.bleu_score([], [], device="cpu")) == 0.0 == float(M.BLEUScore(device="cpu")([], []))
    assert float(tF.bleu_score(["cat mat"], [["cat on mat"]], device="cpu")) == 0.0  # no 4-gram matches
    _close(tF.bleu_score("the cat is on the mat", ["a cat is on the mat"], device="cpu"),
           jF.bleu_score("the cat is on the mat", ["a cat is on the mat"]))
    with pytest.raises(ValueError) as jax_err:
        jF.bleu_score(["a"], [["a"], ["b"]])
    with pytest.raises(ValueError) as port_err:
        tF.bleu_score(["a"], [["a"], ["b"]], device="cpu")
    assert str(port_err.value) == str(jax_err.value)


def test_bleu_equals_nltk():
    """One reference and at least four words a segment: nltk breaks a tie of
    closest reference lengths toward the shorter (the JAX package toward the
    first), and counts at least one n-gram of each order a hypothesis."""
    from nltk.translate.bleu_score import corpus_bleu

    preds, target = zip(*[(p, t) for p, t in zip(*_corpus(3, 60)) if len(p.split()) >= 4])
    refs = [[t.split() for t in tgt] for tgt in target]
    np.testing.assert_allclose(float(tF.bleu_score(preds, target, device="cpu")),
                               corpus_bleu(refs, [p.split() for p in preds]), rtol=1e-5)


# ------------------------------------------------------------------ SacreBLEU
@pytest.mark.parametrize("tokenize", AVAILABLE_TOKENIZERS)
@pytest.mark.parametrize("lowercase", [False, True])
def test_tokenizers_give_the_jax_tokens(tokenize, lowercase):
    lines = [p for p in _corpus(4, 20)[0]] + ZH_PREDS + ["Hello, World! 3.14 -- a&amp;b &lt;tag&gt; x-ray's",
                                                       "<skipped> line-\nbreak\nhere", ""]
    port, jax = _SacreBLEUTokenizer(tokenize, lowercase), JaxTokenizer(tokenize, lowercase)
    for line in lines:
        assert port(line) == jax(line), line


@pytest.mark.parametrize("tokenize", AVAILABLE_TOKENIZERS)
@pytest.mark.parametrize("corpus", ["doc", "wmt", "zh"])
def test_sacre_bleu_is_jax(tokenize, corpus):
    preds, target = {"doc": (BLEU_PREDS, BLEU_TARGETS), "wmt": _corpus(5, 40, refs=2),
                     "zh": (ZH_PREDS, ZH_TARGETS)}[corpus]
    for lowercase in (False, True):
        _close(tF.sacre_bleu_score(preds, target, tokenize=tokenize, lowercase=lowercase, device="cpu"),
               jF.sacre_bleu_score(preds, target, tokenize=tokenize, lowercase=lowercase))


@pytest.mark.parametrize("tokenize", ["13a", "zh", "char"])
def test_sacre_bleu_equals_sacrebleu(tokenize):
    from sacrebleu.metrics import BLEU

    preds, target = (ZH_PREDS, ZH_TARGETS) if tokenize != "13a" else (BLEU_PREDS, BLEU_TARGETS)
    refs = [[t[i] if i < len(t) else "" for t in target] for i in range(max(map(len, target)))]
    if tokenize != "13a":
        refs = [[t[0] for t in target]]
        target = [[t[0]] for t in target]
    expected = BLEU(tokenize=tokenize).corpus_score(preds, refs).score / 100
    np.testing.assert_allclose(float(tF.sacre_bleu_score(preds, target, tokenize=tokenize, device="cpu")), expected,
                               atol=1e-4)


def test_intl_without_regex_raises_the_jax_error(monkeypatch):
    monkeypatch.setattr(jax_sacre_bleu, "_REGEX_AVAILABLE", False)
    monkeypatch.setattr(port_sacre_bleu, "_REGEX_AVAILABLE", False)
    with pytest.raises(ModuleNotFoundError) as jax_err:
        jF.sacre_bleu_score(BLEU_PREDS, BLEU_TARGETS, tokenize="intl")
    with pytest.raises(ModuleNotFoundError) as port_err:
        tF.sacre_bleu_score(BLEU_PREDS, BLEU_TARGETS, tokenize="intl", device="cpu")
    assert str(port_err.value) == str(jax_err.value)


def test_unknown_tokenizer_raises_the_jax_error():
    for make_jax, make_port in ((lambda: jF.sacre_bleu_score(["a"], [["a"]], tokenize="moses"),
                                 lambda: tF.sacre_bleu_score(["a"], [["a"]], tokenize="moses", device="cpu")),
                                (lambda: J.SacreBLEUScore(tokenize="moses"),
                                 lambda: M.SacreBLEUScore(tokenize="moses", device="cpu"))):
        with pytest.raises(ValueError) as jax_err:
            make_jax()
        with pytest.raises(ValueError) as port_err:
            make_port()
        assert str(port_err.value) == str(jax_err.value)


# ----------------------------------------------------------------------- chrF
@pytest.mark.parametrize("n_char_order", [4, 6])
@pytest.mark.parametrize("n_word_order", [0, 2])
@pytest.mark.parametrize("beta", [1.0, 2.0, 3.0])
def test_chrf_orders_and_beta_are_jax(n_char_order, n_word_order, beta):
    preds, target = _corpus(6, 30, refs=2)
    kwargs = {"n_char_order": n_char_order, "n_word_order": n_word_order, "beta": beta}
    got, got_s = tF.chrf_score(preds, target, **kwargs, return_sentence_level_score=True, device="cpu")
    want, want_s = jF.chrf_score(preds, target, **kwargs, return_sentence_level_score=True)
    _close(got, want)
    _close(got_s, want_s)


@pytest.mark.parametrize("lowercase", [False, True])
@pytest.mark.parametrize("whitespace", [False, True])
def test_chrf_lowercase_and_whitespace_are_jax(lowercase, whitespace):
    preds, target = CORPUS_PREDS + ["\tTabs  and Spaces. \n"], [[t] for t in CORPUS_TARGETS] + [["tabs and spaces"]]
    _close(tF.chrf_score(preds, target, lowercase=lowercase, whitespace=whitespace, device="cpu"),
           jF.chrf_score(preds, target, lowercase=lowercase, whitespace=whitespace))


def test_chrf_recorded_values_and_edges():
    assert round(float(tF.chrf_score(["the cat is on the mat"], [["there is a cat on the mat"]], device="cpu")),
                 4) == 0.4942
    assert float(tF.chrf_score([], [], device="cpu")) == 0.0 == float(M.CHRFScore(device="cpu")([], []))
    assert float(tF.chrf_score(["python"], [[]], device="cpu")) == 0.0
    mixed = tF.chrf_score(["the cat is on the mat", "x"], [["a cat is on the mat"], []], device="cpu")
    np.testing.assert_allclose(float(mixed), 0.8591403, atol=1e-6)
    m = M.CHRFScore(return_sentence_level_score=True, device="cpu")
    m.update(["the cat is on the mat", "x"], [["a cat is on the mat"], []])
    corpus, sentences = m.compute()
    _bits(corpus, mixed)
    assert sentences.shape == (2,) and float(sentences[1]) == 0.0


@pytest.mark.parametrize("kwargs", [{"n_char_order": 0}, {"n_char_order": 2.5}, {"n_word_order": -1},
                                    {"beta": -1.0}])
def test_chrf_invalid_arguments_raise_the_jax_errors(kwargs):
    for jax_call, port_call in ((lambda: jF.chrf_score(["a"], [["a"]], **kwargs),
                                 lambda: tF.chrf_score(["a"], [["a"]], **kwargs, device="cpu")),
                                (lambda: J.CHRFScore(**kwargs), lambda: M.CHRFScore(**kwargs, device="cpu"))):
        with pytest.raises(ValueError) as jax_err:
            jax_call()
        with pytest.raises(ValueError) as port_err:
            port_call()
        assert str(port_err.value) == str(jax_err.value)


def _counter_overlap(a, b, max_order):
    out = []
    for n in range(1, max_order + 1):
        ca, cb = port_chrf._ngram_counts(list(a), n), port_chrf._ngram_counts(list(b), n)
        out.append(float(sum((ca & cb).values())))
    return out


def test_ngram_overlap_equals_counters():
    rng = np.random.RandomState(3)
    for trial in range(200):
        na, nb = rng.randint(0, 60, 2)
        vocab = rng.randint(2, 30)
        a = rng.randint(0, vocab, na).astype(np.int32)
        b = rng.randint(0, vocab, nb).astype(np.int32)
        max_order = int(rng.randint(1, 8))
        got = native.ngram_overlap(a, b, max_order)
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, _counter_overlap(a.tolist(), b.tolist(), max_order), err_msg=str(trial))
    empty, one = np.zeros(0, np.int32), np.asarray([5], np.int32)
    np.testing.assert_array_equal(native.ngram_overlap(empty, one, 3), [0.0, 0.0, 0.0])
    np.testing.assert_array_equal(native.ngram_overlap(one, one, 3), [1.0, 0.0, 0.0])
    big_a = np.asarray([0x1F600, 0x1F601, 0x1F600, 0x1F601], np.int32)  # codepoints far above a dense range
    big_b = np.asarray([0x1F601, 0x1F600, 0x1F601], np.int32)
    np.testing.assert_array_equal(native.ngram_overlap(big_a, big_b, 2), _counter_overlap(big_a, big_b, 2))


def test_chrf_core_is_the_counter_paths_bits():
    """Tokenizing, the best reference, both cases and whitespace branches, punctuation."""
    rng = np.random.RandomState(4)
    words = ["the", "cat", "sat.", "on,", "a", "mat!", "HELLO", "world", "...", "x", "\ud800"]

    def sent():
        return " ".join(rng.choice(words, rng.randint(0, 14)))

    for trial in range(60):
        pred, tgts = sent(), [sent() for _ in range(rng.randint(0, 3))]
        args = (6, int(rng.randint(0, 3)), bool(rng.rand() < 0.5), bool(rng.rand() < 0.5), 2.0)
        got = port_chrf._sentence_stats(pred, tgts, *args)
        want = port_chrf._sentence_stats_plain(pred, tgts, *args)
        assert got[0] == want[0], (trial, pred, tgts)
        for g, w in zip(got[1:], want[1:]):
            assert g == w, trial


def test_chrf_module_adds_a_sentence_at_a_time_like_jax_past_2_to_the_24():
    """Sums loaded from a JAX state just under 2**24, then the same batches:
    the port adds a sentence's float32 row at a time, as the JAX package
    does, so the rounded sums are the same bits."""
    jm, tm = J.CHRFScore(), M.CHRFScore(device="cpu")
    jm.persistent(True)
    for key in ("matching", "pred_total", "tgt_total"):
        setattr(jm, key, jnp.full((8,), 2.0**24 - 3.0))
    load_jax_state_dict(tm, jm.state_dict())
    preds, target = _corpus(7, 24)
    for i in range(0, 24, 8):
        jm.update(preds[i:i + 8], target[i:i + 8])
        tm.update(preds[i:i + 8], target[i:i + 8])
        _same_state(tm, jm)
    _bits(tm.compute(), jm.compute())
    assert float(tm.matching.max()) > 2**24  # the sums went past it


# ------------------------------------------------------------------------ TER
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("no_punctuation", [False, True])
@pytest.mark.parametrize("lowercase", [False, True])
@pytest.mark.parametrize("asian_support", [False, True])
def test_ter_flags_are_jax(normalize, no_punctuation, lowercase, asian_support):
    preds, target = _corpus(8, 16, refs=2)
    preds, target = preds + _TER_PREDS + ZH_PREDS, target + _TER_TARGETS + ZH_TARGETS
    kwargs = dict(normalize=normalize, no_punctuation=no_punctuation, lowercase=lowercase,
                  asian_support=asian_support, return_sentence_level_score=True)
    got, got_s = tF.translation_edit_rate(preds, target, **kwargs, device="cpu")
    want, want_s = jF.translation_edit_rate(preds, target, **kwargs)
    _close(got, want)
    assert isinstance(got_s, list) and len(got_s) == len(want_s)
    for g, w in zip(got_s, want_s):
        _bits(g, w)


def test_ter_recorded_value_and_edges():
    assert round(float(tF.translation_edit_rate(["the cat is on the mat"], [BLEU_TARGETS[0]], device="cpu")),
                 4) == 0.1538
    assert float(tF.translation_edit_rate([], [], device="cpu")) == 0.0
    assert float(tF.translation_edit_rate(["python"], [[]], device="cpu")) == 0.0
    assert float(tF.translation_edit_rate([""], [["a b c"]], device="cpu")) == 0.0  # roles reversed: 0 edits
    assert float(tF.translation_edit_rate(["a b"], [[""]], device="cpu")) == 1.0
    assert float(M.TranslationEditRate(device="cpu")([], [])) == 0.0
    assert float(M.TranslationEditRate(device="cpu")(["python"], [[]])) == 0.0
    for kwargs in ({"normalize": 1}, {"no_punctuation": "no"}, {"lowercase": None}, {"asian_support": 0}):
        for jax_call, port_call in ((lambda: jF.translation_edit_rate(["a"], [["a"]], **kwargs),
                                     lambda: tF.translation_edit_rate(["a"], [["a"]], **kwargs, device="cpu")),
                                    (lambda: J.TranslationEditRate(**kwargs),
                                     lambda: M.TranslationEditRate(**kwargs, device="cpu"))):
            with pytest.raises(ValueError) as jax_err:
                jax_call()
            with pytest.raises(ValueError) as port_err:
                port_call()
            assert str(port_err.value) == str(jax_err.value)


def test_ter_core_equals_its_python_dp_path():
    preds, target = _corpus(9, 30, refs=2)
    tokenizer = port_ter._TercomTokenizer(normalize=True)

    def plain(pairs):
        return [_edit_distance_py(a, b) for a, b in pairs]

    assert port_ter._ter_stats(preds, target, tokenizer) == port_ter._ter_stats(preds, target, tokenizer, plain)


def test_ter_equals_sacrebleu():
    from sacrebleu.metrics import TER

    preds, target = _corpus(10, 20)
    expected = TER().corpus_score(preds, [[t[0] for t in target]]).score / 100
    np.testing.assert_allclose(float(tF.translation_edit_rate(preds, target, device="cpu")), expected, atol=1e-3)


# ------------------------------------------------------------------------ EED
@pytest.mark.parametrize("language", ["en", "ja"])
@pytest.mark.parametrize("params", [{}, {"alpha": 1.0, "rho": 0.5, "deletion": 1.0, "insertion": 2.0}])
def test_eed_is_jax(language, params):
    preds, target = _corpus(11, 30, refs=2)
    if language == "ja":
        preds, target = preds[:10] + ["ｶﾀｶﾅ と　全角", "猫が座った。"], target[:10] + [["カタカナと全角"], ["猫が座る。"]]
    got, got_s = tF.extended_edit_distance(preds, target, language, True, **params, device="cpu")
    want, want_s = jF.extended_edit_distance(preds, target, language, True, **params)
    _close(got, want)
    _bits(got_s, want_s)


def test_eed_core_equals_the_numpy_grid():
    rng = np.random.RandomState(3)
    words = ["alpha", "beta", "gamma", "x", "commonword", "Mr.", "3.5"]
    for _ in range(60):
        hyp = " ".join(rng.choice(words, rng.randint(0, 12)))
        ref = " ".join(rng.choice(words, rng.randint(1, 12)))
        for params in ((2.0, 0.3, 0.2, 1.0), (1.0, 0.5, 1.0, 2.0)):
            np.testing.assert_allclose(port_eed._eed_function(hyp, ref, *params),
                                       port_eed._eed_function_plain(hyp, ref, *params), atol=1e-12, rtol=0)


def test_eed_recorded_value_and_edges():
    preds, target = ["this is the prediction", "here is an other sample"], ["this is the reference",
                                                                             "here is another one"]
    assert round(float(tF.extended_edit_distance(preds, target, device="cpu")), 4) == 0.3078
    assert float(tF.extended_edit_distance([], [], device="cpu")) == 0.0
    assert float(tF.extended_edit_distance(["python"], [[]], device="cpu")) == 0.0
    assert float(M.ExtendedEditDistance(device="cpu")([], [])) == 0.0
    corpus, sentences = tF.extended_edit_distance(["python"], [[]], return_sentence_level_score=True, device="cpu")
    assert float(corpus) == 0.0 and bool(torch.isnan(sentences).all())
    mixed, sentences = tF.extended_edit_distance(["hello world", "x"], [["hello word"], []],
                                                 return_sentence_level_score=True, device="cpu")
    _bits(mixed, tF.extended_edit_distance(["hello world"], [["hello word"]], device="cpu"))
    assert sentences.shape == (2,) and bool(torch.isnan(sentences[1]))
    for jax_call, port_call in (
        (lambda: jF.extended_edit_distance(["a"], [["a"]], alpha=-1.0),
         lambda: tF.extended_edit_distance(["a"], [["a"]], alpha=-1.0, device="cpu")),
        (lambda: jF.extended_edit_distance(["a"], [["a"]], rho=1),
         lambda: tF.extended_edit_distance(["a"], [["a"]], rho=1, device="cpu")),
        (lambda: jF.extended_edit_distance(["a"], [["a"]], language="de"),
         lambda: tF.extended_edit_distance(["a"], [["a"]], language="de", device="cpu")),
        (lambda: jF.extended_edit_distance([], [], return_sentence_level_score=True),
         lambda: tF.extended_edit_distance([], [], return_sentence_level_score=True, device="cpu")),
        (lambda: jF.extended_edit_distance(["a"], []), lambda: tF.extended_edit_distance(["a"], [], device="cpu")),
        (lambda: J.ExtendedEditDistance(language="de"), lambda: M.ExtendedEditDistance(language="de", device="cpu")),
        (lambda: J.ExtendedEditDistance(insertion=2), lambda: M.ExtendedEditDistance(insertion=2, device="cpu")),
    ):
        with pytest.raises(ValueError) as jax_err:
            jax_call()
        with pytest.raises(ValueError) as port_err:
            port_call()
        assert str(port_err.value) == str(jax_err.value)


# -------------------------------------------------------------------- modules
MODULES = {
    "BLEUScore": {},
    "BLEUScore smooth": {"n_gram": 3, "smooth": True},
    "SacreBLEUScore": {"tokenize": "13a"},
    "SacreBLEUScore char": {"tokenize": "char", "lowercase": True},
    "CHRFScore": {"return_sentence_level_score": True},
    "CHRFScore chrF": {"n_word_order": 0},
    "TranslationEditRate": {"return_sentence_level_score": True},
    "TranslationEditRate normalize": {"normalize": True, "asian_support": True},
    "ExtendedEditDistance": {"return_sentence_level_score": True},
}


def _module(pkg, case):
    kwargs = dict(MODULES[case], **({} if pkg is J else {"device": "cpu"}))
    return getattr(pkg, case.split()[0])(**kwargs)


def _batches(seed, n=3, size=8, refs=2):
    preds, target = _corpus(seed, n * size, refs=refs)
    return [(preds[i:i + size], target[i:i + size]) for i in range(0, n * size, size)]


def _same_value(got, want):
    if isinstance(want, tuple):
        _close(got[0], want[0])
        _close(got[1], want[1])
    else:
        _close(got, want)


@pytest.mark.parametrize("case", MODULES)
def test_module_update_forward_compute_reset_equal_jax(case):
    jm, tm = _module(J, case), _module(M, case)
    (p0, t0), (p1, t1), (p2, t2) = _batches(20)
    jm.update(p0, t0)
    tm.update(p0, t0)
    _same_state(tm, jm)
    _same_value(tm(p1, t1), jm(p1, t1))
    _same_state(tm, jm)
    jm.update(p2, t2)
    tm.update(p2, t2)
    _same_state(tm, jm)
    _same_value(tm.compute(), jm.compute())
    tm.reset()
    for key, default in tm._defaults.items():
        value = getattr(tm, key)
        assert value == [] if isinstance(default, list) else (torch.equal(value, default) and value.dtype == torch.float32)


@pytest.mark.parametrize("case", MODULES)
def test_module_checkpoints_cross_between_jax_and_port(case):
    """JAX -> port -> JAX mid-corpus (list states included), then one more
    batch in all three: the same states."""
    jm, tm, back = _module(J, case), _module(M, case), _module(J, case)
    for m in (jm, tm, back):
        m.persistent(True)
    (p0, t0), (p1, t1) = _batches(21, n=2)
    jm.update(p0, t0)
    load_jax_state_dict(tm, jm.state_dict())
    _same_state(tm, jm)
    back.load_state_dict(to_jax_state_dict(tm))
    for m in (jm, back):
        m.update(p1, t1)
    tm.update(p1, t1)
    _same_state(tm, jm)
    _same_state(tm, back)
    _same_value(tm.compute(), jm.compute())


def _synced(case):
    """``fn(rank, env)`` for :func:`run_ranks` of each package: each rank
    updates with its own batches, computes (a sync through the env) and
    syncs; its value, states and ``sync_stats``."""
    data = [_batches(30 + r, n=1 + r) for r in range(2)]

    def make(pkg):
        def fn(rank, env):
            m = _module(pkg, case)
            m._sync_env = env
            for p, t in data[rank]:
                m.update(p, t)
            value = m.compute()
            m.sync(env=env)
            value = tuple(_np(v) for v in value) if isinstance(value, tuple) else _np(value)
            return value, {k: _leaf(getattr(m, k)) for k in m._defaults}, dict(m.sync_stats)

        return fn

    single = _module(M, case)
    for p, t in data[0] + data[1]:
        single.update(p, t)
    return make, single


@pytest.mark.parametrize("case", ["BLEUScore", "CHRFScore", "TranslationEditRate"])
def test_sync_on_two_ranks_equals_jax(case):
    """``compute`` syncs sums and cat lists through the env: the same states
    and values as the JAX package's and as one process over both ranks'
    batches."""
    make, single = _synced(case)
    touts, jouts = run_ranks(make(M), TorchPair), run_ranks(make(J), JaxPair)
    for (tv, ts, tstats), (jv, js, jstats) in zip(touts, jouts):
        _same_value(tv, jv)
        _same_value(tv, tuple(_np(v) for v in single.compute()) if isinstance(tv, tuple) else single.compute())
        for key in js:
            got = np.concatenate([np.atleast_1d(x) for x in ts[key]]) if isinstance(ts[key], list) else ts[key]
            want = np.concatenate([np.atleast_1d(x) for x in js[key]]) if isinstance(js[key], list) else js[key]
            _bits(got, want)
        assert tstats == jstats


def test_eed_synced_over_two_ranks_computes_where_jax_raises():
    """A reference fault not copied (ROADMAP.md Queue C): the JAX package's
    EED compute tests the truth of the gathered score array and raises; the
    port's takes the gathered tensor and gives the one-process value."""
    make, single = _synced("ExtendedEditDistance")
    with pytest.raises(ValueError, match="truth value of an array"):
        run_ranks(make(J), JaxPair)
    for value, states, _ in run_ranks(make(M), TorchPair):
        _close(value[0], _np(single.compute()[0]))
        _bits(value[1], _np(single.compute()[1]))
        _bits(states["sentence_eed"], torch.cat(single.sentence_eed))


@pytest.mark.parametrize("name", ["BLEUScore", "SacreBLEUScore", "CHRFScore", "TranslationEditRate",
                                  "ExtendedEditDistance"])
def test_host_only_warns_and_runs_eagerly_like_jax(name):
    assert getattr(M, name).host_only is True
    with pytest.warns(UserWarning, match="host_only") as jax_warned:
        jm = getattr(J, name)(jit_update=True)
    with pytest.warns(UserWarning, match="host_only") as port_warned:
        tm = getattr(M, name)(jit_update=True, device="cpu")
    assert [str(w.message) for w in port_warned] == [str(w.message) for w in jax_warned]
    jm.update(BLEU_PREDS, BLEU_TARGETS)
    tm.update(BLEU_PREDS, BLEU_TARGETS)
    _same_state(tm, jm)
    assert tm._dispatcher is None


def test_service_serves_text_templates_where_jax_fails_to_coalesce_a_session():
    """A text template in ``MetricsService``: each request runs the eager
    update (no stacked launch), one session's value a dedicated metric's. A
    reference fault not copied (ROADMAP.md Queue C): where one session submits
    twice in a flush, the JAX package's coalescing turns the strings into
    arrays and the flush raises; the port's leaves them to the eager path."""
    from metrics_tpu.serve import MetricsService as JaxService
    from metrics_tpu_torch.serve import MetricsService

    batches = _batches(40, n=3)
    jax_service, service = JaxService(J.BLEUScore()), MetricsService(M.BLEUScore(device="cpu"))
    for i, (p, t) in enumerate(batches):
        for s in (jax_service, service):
            s.submit(f"s{i}", p, t)
    jax_service.drain()
    service.drain()
    for i, (p, t) in enumerate(batches):
        dedicated = M.BLEUScore(device="cpu")
        dedicated.update(p, t)
        _bits(service.compute(f"s{i}"), dedicated.compute())
        _close(service.compute(f"s{i}"), jax_service.compute(f"s{i}"))
    assert service.stats["launches"] == 0 and service.stats["fallback_requests"] == 3

    jax_service, service = JaxService(J.BLEUScore()), MetricsService(M.BLEUScore(device="cpu"))
    for s in (jax_service, service):
        s.submit("a", *batches[0])
        s.submit("a", *batches[1])
    with pytest.raises(TypeError, match="not a valid JAX array type"):
        jax_service.drain()
    service.drain()
    dedicated = M.BLEUScore(device="cpu")
    for p, t in batches[:2]:
        dedicated.update(p, t)
    _bits(service.compute("a"), dedicated.compute())
    assert service.stats["coalesced_requests"] == 0 and service.stats["fallback_requests"] == 2
