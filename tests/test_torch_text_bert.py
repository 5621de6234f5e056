"""The port's SQuAD and BERTScore held against the JAX package on the CPU.

The same seeded numpy corpora go through ``metrics_tpu`` and
``metrics_tpu_torch``. Tolerances:

* exact: SQuAD's outputs and states; the hash embedder's embeddings, masks
  and ids; the IDF weights; the special-token exclusion's masks, every mask
  (all-zero rows and interior zeros included);
* BERTScore's precision, recall and F1: rtol 1e-5, atol 1e-6 (norms and
  products summed in another order); identical pairs give 1 within 1e-6;
* the Hugging Face embedder hook, a tiny BERT built here with Flax and its
  PyTorch weights written from it: ids and masks exact, embeddings atol
  1e-5, scores atol 1e-5 (two libraries' float32 networks).

Where the JAX package raises, the port raises the same type with the same message.
"""
import os
import string

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as J
import metrics_tpu.functional as jF
import metrics_tpu_torch as M
import metrics_tpu_torch.functional as tF
from metrics_tpu.functional.text import bert as jax_bert
from metrics_tpu_torch.functional.text import bert as port_bert
from metrics_tpu_torch.interop import load_jax_state_dict, to_jax_state_dict
from tests.test_torch_image_paths import JaxPair, TorchPair, run_ranks

WORDS = ["the", "a", "an", "denver", "broncos", "super", "bowl", "50", "1976", "carolina", "panthers", "levi's",
         "stadium", "santa", "clara", "california", "february", "7,", "2016", "nfl", "afc", "champion"]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bits(t, j):
    got, want = _np(t), np.asarray(j)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


def _scores_close(got, want, rtol=1e-5, atol=1e-6):
    assert sorted(got) == sorted(want)  # a module's compute sorts its dict's keys in the JAX package
    for key in want:
        g, w = _np(got[key]), np.asarray(want[key])
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape, (key, g.dtype, w.dtype, g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=key)


# ---------------------------------------------------------------------- SQuAD
def _answer(rng):
    words = list(rng.choice(WORDS, rng.randint(1, 5)))
    if rng.rand() < 0.3:
        words[0] = words[0].capitalize()
    text = " ".join(words)
    return text + rng.choice(["", ".", "!", " ,"]) if rng.rand() < 0.3 else text


def _squad(seed, n):
    """``n`` questions with 1-6 gold answers; each prediction is a gold
    answer (with case, punctuation and articles changed), a partial overlap,
    something else or empty; a tenth of the questions have no prediction and
    some gold answers are empty."""
    rng = np.random.RandomState(seed)
    preds, targets = [], []
    for i in range(n):
        qid = f"q{seed}-{i}"
        answers = [_answer(rng) for _ in range(rng.randint(1, 7))]
        if rng.rand() < 0.1:
            answers[rng.randint(len(answers))] = ""
        targets.append({"answers": {"answer_start": [0] * len(answers), "text": answers}, "id": qid})
        pick = rng.rand()
        gold = answers[rng.randint(len(answers))]
        if pick < 0.35:
            text = "The " + gold.upper() + string.punctuation[rng.randint(len(string.punctuation))]
        elif pick < 0.7:
            text = " ".join(gold.split()[:1] + list(rng.choice(WORDS, rng.randint(0, 3))))
        elif pick < 0.85:
            text = _answer(rng)
        else:
            text = ""
        if rng.rand() >= 0.1:
            preds.append({"prediction_text": text, "id": qid})
    return preds, targets


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_squad_functional_is_jax(seed):
    preds, targets = _squad(seed, 120)
    got, want = tF.squad(preds, targets, device="cpu"), jF.squad(preds, targets)
    assert list(got) == list(want)
    for key in want:
        _bits(got[key], want[key])
    one = tF.squad(preds[0], targets[0], device="cpu")
    for key, value in jF.squad(preds[0], targets[0]).items():
        _bits(one[key], value)


def _same_state(tm, jm):
    for key in tm._defaults:
        _bits(getattr(tm, key), getattr(jm, key))


def test_squad_module_update_forward_compute_reset_equal_jax():
    jm, tm = J.SQuAD(), M.SQuAD(device="cpu")
    batches = [_squad(10 + i, 40) for i in range(4)]
    for i, (p, t) in enumerate(batches):
        if i == 2:
            got, want = tm(p, t), jm(p, t)
            for key in want:
                _bits(got[key], want[key])
        else:
            jm.update(p, t)
            tm.update(p, t)
        _same_state(tm, jm)
    for key, value in jm.compute().items():
        _bits(tm.compute()[key], value)
    assert tm.total.dtype == torch.int32 and tm.f1_score.dtype == tm.exact_match.dtype == torch.float32
    tm.reset()
    assert float(tm.f1_score) == 0.0 and int(tm.total) == 0 and tm.total.dtype == torch.int32


def test_squad_sums_are_added_in_float32_like_jax_past_2_to_the_24():
    """Each update adds its sum as one float32 number: past 2**24 the order of the adds shows."""
    jm, tm = J.SQuAD(), M.SQuAD(device="cpu")
    preds, targets = _squad(20, 60)
    start = {"f1_score": 2.0 ** 24 + 1, "exact_match": 2.0 ** 24 + 3, "total": 2 ** 25}
    load_jax_state_dict(tm, {k: np.asarray(v, dtype=np.int32 if k == "total" else np.float32) for k, v in start.items()})
    jm.f1_score, jm.exact_match, jm.total = (jnp.asarray(np.float32(start["f1_score"])),
                                             jnp.asarray(np.float32(start["exact_match"])),
                                             jnp.asarray(np.int32(start["total"])))
    for i in range(0, 60, 7):
        jm.update(preds[i:i + 7], targets[i:i + 7])
        tm.update(preds[i:i + 7], targets[i:i + 7])
        _same_state(tm, jm)


@pytest.mark.parametrize("bad", ["pred", "target", "answers"])
def test_squad_key_errors_are_jax(bad):
    preds, targets = [{"prediction_text": "a", "id": "x"}], [{"answers": {"text": ["a"]}, "id": "x"}]
    if bad == "pred":
        preds = [{"prediction": "a", "id": "x"}]
    elif bad == "target":
        targets = [{"answer": {"text": ["a"]}, "id": "x"}]
    else:
        targets = [{"answers": {"texts": ["a"]}, "id": "x"}]
    with pytest.raises(KeyError) as jax_err:
        jF.squad(preds, targets)
    with pytest.raises(KeyError) as port_err:
        tF.squad(preds, targets, device="cpu")
    assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(KeyError) as port_err:
        M.SQuAD(device="cpu").update(preds, targets)
    assert str(port_err.value) == str(jax_err.value)


def test_squad_checkpoints_and_two_rank_sync_are_jax():
    jm, tm, back = J.SQuAD(), M.SQuAD(device="cpu"), J.SQuAD()
    for m in (jm, tm, back):
        m.persistent(True)
    (p0, t0), (p1, t1) = _squad(30, 50), _squad(31, 50)
    jm.update(p0, t0)
    load_jax_state_dict(tm, jm.state_dict())
    _same_state(tm, jm)
    back.load_state_dict(to_jax_state_dict(tm))
    for m in (jm, back, tm):
        m.update(p1, t1)
    _same_state(tm, jm)
    _same_state(tm, back)

    data = [_squad(40 + r, 30 + 20 * r) for r in range(2)]

    def make(pkg, kwargs):
        def fn(rank, env):
            m = pkg.SQuAD(**kwargs)
            m._sync_env = env
            m.update(*data[rank])
            return {k: _np(v) for k, v in m.compute().items()}

        return fn

    single = M.SQuAD(device="cpu")
    for p, t in data:
        single.update(p, t)
    for tv, jv in zip(run_ranks(make(M, {"device": "cpu"}), TorchPair), run_ranks(make(J, {}), JaxPair)):
        for key in jv:
            _bits(tv[key], jv[key])
            _bits(tv[key], single.compute()[key])


# ------------------------------------------------------------------ BERTScore
def _sentences(seed, n, identical_share=0.2):
    rng = np.random.RandomState(seed)
    preds, targets = [], []
    for _ in range(n):
        tgt = " ".join(rng.choice(WORDS, rng.randint(1, 30)))
        if rng.rand() < identical_share:
            pred = tgt
        else:
            pred = " ".join(w if rng.rand() > 0.3 else rng.choice(WORDS) for w in tgt.split() if rng.rand() > 0.15)
        preds.append(pred)
        targets.append(tgt)
    return preds, targets


def test_hash_embedder_outputs_are_jax_bit_for_bit():
    preds, targets = _sentences(0, 40)
    sentences = preds + targets + ["", "Hello, World!", "naïve café — 東京"]
    for dim, max_length, context in ((128, 128, 0.3), (64, 7, 0.0), (32, 16, 0.5)):
        j = jax_bert.HashEmbedder(dim=dim, max_length=max_length, context_weight=context)(sentences)
        t = port_bert.HashEmbedder(dim=dim, max_length=max_length, context_weight=context, device="cpu")(sentences)
        for got, want in zip(t, j):
            _bits(got, want)


@pytest.mark.parametrize("idf", [False, True])
def test_default_embedder_scores_are_jax(idf):
    preds, targets = _sentences(1, 64)
    got = tF.bert_score(preds, targets, idf=idf, device="cpu")
    _scores_close(got, jF.bert_score(preds, targets, idf=idf))
    same = [i for i, (p, t) in enumerate(zip(preds, targets)) if p == t and p]
    assert same
    for key in got:
        np.testing.assert_allclose(_np(got[key])[same], 1.0, rtol=0, atol=1e-6)


def test_idf_dict_and_weights_are_jax_bit_for_bit():
    preds, targets = _sentences(2, 50)
    emb = jax_bert.HashEmbedder()
    _, tgt_mask, tgt_ids = emb(targets)
    _, pred_mask, pred_ids = emb(preds)
    idf_jax = jax_bert._compute_idf(tgt_ids, tgt_mask)
    idf_port = port_bert._compute_idf(np.asarray(tgt_ids), np.asarray(tgt_mask))
    assert idf_port == idf_jax
    for ids, mask in ((pred_ids, pred_mask), (tgt_ids, tgt_mask)):
        _bits(port_bert._idf_weights(np.asarray(ids), np.asarray(mask), idf_port),
              jax_bert._idf_weights(ids, mask, idf_jax))


def test_rescale_with_baseline_and_its_error_are_jax():
    preds, targets = _sentences(3, 20)
    baseline = {"precision": 0.3, "recall": 0.25, "f1": 0.28}
    got = tF.bert_score(preds, targets, rescale_with_baseline=True, baseline=baseline, device="cpu")
    _scores_close(got, jF.bert_score(preds, targets, rescale_with_baseline=True, baseline=baseline))
    with pytest.raises(ValueError) as jax_err:
        jF.bert_score(preds, targets, rescale_with_baseline=True)
    with pytest.raises(ValueError) as port_err:
        tF.bert_score(preds, targets, rescale_with_baseline=True, device="cpu")
    assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError) as jax_err:
        jF.bert_score(["a"], ["a", "b"])
    with pytest.raises(ValueError) as port_err:
        tF.bert_score(["a"], ["a", "b"], device="cpu")
    assert str(port_err.value) == str(jax_err.value)


def _masks(rng, n, length, kind):
    if kind == "right-padded":
        lengths = rng.randint(0, length + 1, n)
        return (np.arange(length)[None] < lengths[:, None]).astype(np.int32)
    if kind == "all-zero":
        return np.zeros((n, length), np.int32)
    return (rng.rand(n, length) < rng.rand(n, 1)).astype(np.int32)  # interior zeros


@pytest.mark.parametrize("length", [1, 2, 5, 16, 17, 33, 100, 300, 512])
def test_special_token_exclusion_is_jax_on_every_mask(length):
    """The [SEP] position is the first maximum of a float32 running sum, so
    exact ties (masks with interior zeros) resolve as the JAX package's
    rounding resolves them: the same masks out, every row."""
    rng = np.random.RandomState(length)
    for kind in ("right-padded", "all-zero", "interior zeros"):
        mask = _masks(rng, 2000, length, kind)
        want = np.asarray(jax_bert._exclude_special_tokens(jnp.asarray(mask)))
        _bits(port_bert._exclude_special_tokens(torch.from_numpy(mask)), want)
    zero = port_bert._exclude_special_tokens(torch.zeros((3, length), dtype=torch.int32))
    assert not zero.any()


def test_running_sum_ties_are_resolved_like_jax():
    """Masks whose exact running sums tie (a one, then nine zeros, then a
    one, ...): the float32 sums must pick the JAX package's position, which
    is not always the last attended one."""
    rows = []
    for gap in range(8, 12):
        for ones in range(1, 5):
            row = np.zeros(128, np.int32)
            row[1:1 + (gap + 1) * ones:gap + 1] = 1
            rows.append(row)
    mask = np.stack(rows)
    want = np.asarray(jax_bert._exclude_special_tokens(jnp.asarray(mask)))
    got = port_bert._exclude_special_tokens(torch.from_numpy(mask))
    _bits(got, want)
    last = mask.shape[1] - 1 - np.argmax(mask[:, ::-1], axis=1)
    assert (want[np.arange(len(rows)), last] == 1).any()  # a tie left the last one attended


class _SpecialsEmbedder:
    """[CLS] + hashed tokens + [SEP], right-padded, with masks that may hold interior zeros."""

    def __init__(self, pkg_to, holes):
        self.inner, self.to, self.holes = jax_bert.HashEmbedder(dim=16), pkg_to, holes

    def __call__(self, sentences):
        emb, mask, ids = (np.asarray(x) for x in self.inner([f"cls {s} sep" for s in sentences]))
        if self.holes:
            mask = mask * (np.random.RandomState(len(sentences)).rand(*mask.shape) > 0.2)
        return self.to(emb), self.to(mask.astype(np.int32)), self.to(ids)


@pytest.mark.parametrize("holes", [False, True])
@pytest.mark.parametrize("idf", [False, True])
def test_specials_embedder_scores_are_jax(holes, idf):
    preds, targets = _sentences(4, 30)
    got = tF.bert_score(preds, targets, embedder=_SpecialsEmbedder(torch.from_numpy, holes), idf=idf, device="cpu")
    want = jF.bert_score(preds, targets, embedder=_SpecialsEmbedder(jnp.asarray, holes), idf=idf)
    _scores_close(got, want)


@pytest.mark.parametrize("lengths", [(3, 3), (5, 11), (8, 8), (9, 17), (33, 20)])
def test_lengths_off_the_power_of_two_bucket_are_jax(lengths):
    """Both sides padded to a power of two, as in the JAX package: a row
    whose similarities are all negative is floored at 0 by a padded column."""
    rng = np.random.RandomState(sum(lengths))
    lp, lt = lengths
    pred_emb, tgt_emb = rng.standard_normal((6, lp, 8)).astype(np.float32), rng.standard_normal((6, lt, 8)).astype(np.float32)
    pred_mask, tgt_mask = np.ones((6, lp), np.int32), np.ones((6, lt), np.int32)

    def embedder(to):
        return lambda s: ((to(pred_emb), to(pred_mask), to(np.arange(lp * 6).reshape(6, lp))) if s[0] == "p"
                          else (to(tgt_emb), to(tgt_mask), to(np.arange(lt * 6).reshape(6, lt))))

    preds, targets = ["p"] * 6, ["t"] * 6
    got = tF.bert_score(preds, targets, embedder=embedder(torch.from_numpy), exclude_special_tokens=False,
                        device="cpu")
    _scores_close(got, jF.bert_score(preds, targets, embedder=embedder(jnp.asarray), exclude_special_tokens=False))


def test_bert_module_is_jax_and_resets():
    preds, targets = _sentences(5, 24)
    jm, tm = J.BERTScore(idf=True), M.BERTScore(idf=True, device="cpu")
    for i in range(0, 24, 8):
        jm.update(preds[i:i + 8], targets[i:i + 8])
        tm.update(preds[i:i + 8], targets[i:i + 8])
    _scores_close(tm.compute(), jm.compute())
    _scores_close(tm.compute(), tF.bert_score(preds, targets, idf=True, device="cpu"), rtol=0, atol=0)
    tm.reset()
    assert tm._preds == [] and tm._target == []
    with pytest.raises(ValueError, match="must be the same"):
        tm.update(["a"], ["a", "b"])


_VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "hello", "there", "world", "the", "cat", "sat", "on", "mat",
          "a", "dog", "ran", "fast", "##s", "##ing"]


@pytest.fixture(scope="module")
def tiny_checkpoint(tmp_path_factory):
    """A one-layer BERT made with Flax (``FlaxBertModel(seed=0)``), its
    PyTorch weights written from the Flax ones."""
    pytest.importorskip("flax")
    from transformers import BertConfig, BertModel, BertTokenizerFast, FlaxBertModel
    from transformers.modeling_flax_pytorch_utils import load_flax_checkpoint_in_pytorch_model

    d = str(tmp_path_factory.mktemp("tiny_bert"))
    with open(os.path.join(d, "vocab.txt"), "w") as f:
        f.write("\n".join(_VOCAB))
    tokenizer = BertTokenizerFast(vocab_file=os.path.join(d, "vocab.txt"), do_lower_case=True)
    config = BertConfig(vocab_size=len(_VOCAB), hidden_size=8, num_hidden_layers=1, num_attention_heads=2,
                        intermediate_size=16, max_position_embeddings=64)
    tokenizer.save_pretrained(d)
    FlaxBertModel(config, seed=0).save_pretrained(d)
    load_flax_checkpoint_in_pytorch_model(BertModel(config), os.path.join(d, "flax_model.msgpack")).save_pretrained(d)
    return d


def test_transformers_embedder_is_the_flax_embedder(tiny_checkpoint):
    port = port_bert.transformers_embedder(tiny_checkpoint, max_length=32, device="cpu")
    jax_side = jax_bert.transformers_flax_embedder(tiny_checkpoint, max_length=32)
    sentences = ["hello there", "the cat sat on the mat", "a dog ran fast", "the cats sating"]
    (t_emb, t_mask, t_ids), (j_emb, j_mask, j_ids) = port(sentences), jax_side(sentences)
    np.testing.assert_array_equal(_np(t_ids), np.asarray(j_ids))
    np.testing.assert_array_equal(_np(t_mask), np.asarray(j_mask))
    np.testing.assert_allclose(_np(t_emb), np.asarray(j_emb), rtol=0, atol=1e-5)

    preds, targets = ["hello there", "the cat sat", "a dog"], ["hello world", "the cat sat on the mat", "a dog ran fast"]
    for idf in (False, True):
        got = tF.bert_score(preds, targets, embedder=port, idf=idf, device="cpu")
        want = jF.bert_score(preds, targets, embedder=jax_side, idf=idf)
        _scores_close(got, want, rtol=0, atol=1e-5)
    by_path = tF.bert_score(preds, targets, model_name_or_path=tiny_checkpoint, device="cpu")
    for key, value in tF.bert_score(preds, targets, embedder=port_bert.transformers_embedder(tiny_checkpoint, device="cpu"),
                                    device="cpu").items():
        _bits(by_path[key], value)
    self_score = tF.bert_score(preds, preds, embedder=port, device="cpu")
    np.testing.assert_allclose(_np(self_score["f1"]), 1.0, atol=1e-5)


def test_transformers_embedder_without_transformers_names_the_package(monkeypatch):
    monkeypatch.setattr(port_bert, "_TRANSFORMERS_AVAILABLE", False)
    with pytest.raises(ModuleNotFoundError, match="`transformers`"):
        port_bert.transformers_embedder("any/path", device="cpu")
    with pytest.raises(ModuleNotFoundError, match="`transformers`"):
        tF.bert_score(["a"], ["a"], model_name_or_path="any/path", device="cpu")


@pytest.mark.parametrize("name", ["SQuAD", "BERTScore"])
def test_host_only_warns_and_runs_eagerly_like_jax(name):
    assert getattr(M, name).host_only is True
    with pytest.warns(UserWarning, match="host_only") as jax_warned:
        getattr(J, name)(jit_update=True)
    with pytest.warns(UserWarning, match="host_only") as port_warned:
        tm = getattr(M, name)(jit_update=True, device="cpu")
    assert [str(w.message) for w in port_warned] == [str(w.message) for w in jax_warned]
    assert tm._dispatcher is None
