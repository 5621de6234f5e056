"""``MetricCollection`` of the port held against the JAX package on the CPU.

The cases of ``tests/bases/test_collections.py`` that need no fused engine
and no sync, plus the compute groups of real metric families. The same
seeded numpy inputs go through both packages. States and counts must be
exactly equal and of equal dtype, compute groups identical, and float
values equal to ``rtol=1e-6`` (float32 in both, summed in another order);
Cohen's kappa is also allowed ``atol=2**-23``, one float32 step at 1.0, as
in ``tests/test_torch_confusion.py``.

Two places where the port differs from the JAX package on purpose, both
faults of the reference (ROADMAP.md, Queue C): members without a state of
their own never share a group, and a group member drops its memoised
``compute`` when it takes its leader's new state. There the port's grouped
values are held against the JAX package's ungrouped ones.
"""
import importlib
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu
import metrics_tpu_torch
from metrics_tpu.collections import MetricCollection as JaxCollection
from metrics_tpu.metric import Metric as JaxMetric
from metrics_tpu_torch import Metric, MetricCollection
from metrics_tpu_torch.interop import load_jax_state_dict, to_jax_state_dict
from metrics_tpu_torch.utilities.exceptions import StateCorruptionError
from tests.helpers.testers import DummyMetricDiff, DummyMetricMultiOutput, DummyMetricSum

RTOL = 1e-6
KAPPA_ATOL = 2.0**-23
C = 3


# ------------------------------------------------------------------ dummies
class TorchSum(Metric):
    full_state_update = True

    def __init__(self):
        super().__init__(device="cpu")
        self.add_state("x", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, x):
        self.x = self.x + x

    def compute(self):
        return self.x


class TorchDiff(TorchSum):
    def update(self, y):
        self.x = self.x - y


class TorchMultiOutput(TorchSum):
    def compute(self):
        return [self.x, self.x]


def _stats_classes(base, xp, **dev):
    """Two metrics of equal states (one group) and one of another state."""

    class StatsA(base):
        full_state_update = False

        def __init__(self):
            super().__init__(**dev)
            self.add_state("total", xp.asarray(0.0) if xp is jnp else torch.tensor(0.0), dist_reduce_fx="sum")
            self.add_state("count", xp.asarray(0.0) if xp is jnp else torch.tensor(0.0), dist_reduce_fx="sum")

        def update(self, x):
            self.total = self.total + x.sum()
            self.count = self.count + (x.size if xp is jnp else x.numel())

        def compute(self):
            return self.total / self.count

    class StatsB(StatsA):
        def compute(self):
            return self.total * 2

    class Other(base):
        full_state_update = False

        def __init__(self):
            super().__init__(**dev)
            self.add_state("prod", xp.asarray(1.0) if xp is jnp else torch.tensor(1.0), dist_reduce_fx="sum")

        def update(self, x):
            self.prod = self.prod * x.prod()

        def compute(self):
            return self.prod

    return StatsA, StatsB, Other


JaxStatsA, JaxStatsB, JaxOther = _stats_classes(JaxMetric, jnp)
TorchStatsA, TorchStatsB, TorchOther = _stats_classes(Metric, torch, device="cpu")


# ------------------------------------------------------------------ helpers
def _pair(x):
    """The same values for both packages, in the dtype the JAX package takes them in."""
    j = jnp.asarray(x)
    return j, torch.from_numpy(np.array(j))


def _same(jax_val, torch_val, exact=False, atol=0.0):
    if isinstance(jax_val, (list, tuple)):
        assert len(jax_val) == len(torch_val)
        for j, t in zip(jax_val, torch_val):
            _same(j, t, exact, atol)
        return
    ref, got = np.asarray(jax_val), torch_val.numpy()
    assert got.dtype == ref.dtype, (got.dtype, ref.dtype)
    assert got.shape == ref.shape
    if exact:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=atol)


def _same_results(jax_res, torch_res):
    assert list(jax_res) == list(torch_res)
    for key in jax_res:
        _same(jax_res[key], torch_res[key], atol=KAPPA_ATOL if "Kappa" in key else 0.0)


def _same_port_results(a, b):
    """Two port results equal bit for bit."""
    assert list(a) == list(b)
    for key in a:
        _bit_equal(a[key], b[key])


def _bit_equal(a, b):
    if isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _bit_equal(x, y)
        return
    assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def _assert_states(jm, tm):
    assert list(jm._defaults) == list(tm._defaults)
    for name in jm._defaults:
        ref, got = getattr(jm, name), getattr(tm, name)
        if isinstance(ref, list):
            assert isinstance(got, list) and len(got) == len(ref)
            for r, g in zip(ref, got):
                _same(r, g, exact=True)
        else:
            _same(ref, got, exact=True)


def _scores(n, c, seed):
    rng = np.random.RandomState(seed)
    logits = rng.rand(n, c).astype(np.float32)
    return logits / logits.sum(-1, keepdims=True), rng.randint(0, c, n)


def _groups(mc):
    return {frozenset(v) for v in mc.compute_groups.values()}


def _imagenet_list(mod, c, **dev):
    """The evaluation collection of ``chip_smoke.py``'s slice 7 at ``c`` classes."""
    macro = dict(num_classes=c, average="macro", **dev)
    return [
        mod.Accuracy(**macro), mod.Precision(**macro), mod.Recall(**macro), mod.F1Score(**macro),
        mod.FBetaScore(beta=0.5, **macro), mod.Specificity(**macro), mod.HammingDistance(**dev),
        mod.ConfusionMatrix(c, update_method="matmul", **dev),
        mod.CohenKappa(c, weights="quadratic", update_method="matmul", **dev),
        mod.MatthewsCorrCoef(c, update_method="matmul", **dev),
        mod.JaccardIndex(c, update_method="matmul", **dev),
    ]


# ------------------------------------------------- tests/bases/test_collections.py
def test_list_dict_varargs_and_one_metric():
    mc = MetricCollection([TorchSum(), TorchDiff()])
    assert list(mc.keys()) == ["TorchSum", "TorchDiff"] and "TorchSum" in mc and len(mc) == 2
    mc.update(torch.tensor(5.0))  # positional args reach every member
    assert float(mc["TorchSum"].x) == 5.0 and float(mc.TorchDiff.x) == -5.0
    assert list(MetricCollection(TorchSum(), TorchDiff()).keys()) == ["TorchSum", "TorchDiff"]
    assert list(MetricCollection(TorchSum()).keys()) == ["TorchSum"]
    # a dict's keys are taken sorted, as in the JAX package
    jd = JaxCollection({"b": DummyMetricSum(), "a": DummyMetricDiff()})
    td = MetricCollection({"b": TorchSum(), "a": TorchDiff()})
    assert list(td.keys()) == list(jd.keys()) == ["a", "b"]
    assert list(td) == ["a", "b"]


def test_construction_errors_match_the_jax_package():
    cases = [
        (lambda: JaxCollection([DummyMetricSum(), DummyMetricSum()]), lambda: MetricCollection([TorchSum(), TorchSum()])),
        (lambda: JaxCollection({"a": DummyMetricSum()}, DummyMetricDiff()),
         lambda: MetricCollection({"a": TorchSum()}, TorchDiff())),
        (lambda: JaxCollection([DummyMetricSum(), 5]), lambda: MetricCollection([TorchSum(), 5])),
        (lambda: JaxCollection({"a": 5}), lambda: MetricCollection({"a": 5})),
        (lambda: JaxCollection(5), lambda: MetricCollection(5)),
        (lambda: JaxCollection([DummyMetricSum()], prefix=1), lambda: MetricCollection([TorchSum()], prefix=1)),
        (lambda: JaxCollection([DummyMetricSum()], compute_groups=[["x"]]),
         lambda: MetricCollection([TorchSum()], compute_groups=[["x"]])),
    ]
    for jax_call, torch_call in cases:
        with pytest.raises(ValueError) as jax_err:
            jax_call()
        with pytest.raises(ValueError) as torch_err:
            torch_call()
        assert str(torch_err.value).replace("Torch", "Dummy") == str(jax_err.value).replace("DummyMetric", "Dummy")
    with pytest.warns(UserWarning, match="not `Metric`"):
        mc = MetricCollection([TorchSum()], 5)
    assert list(mc.keys()) == ["TorchSum"]


def test_prefix_postfix_and_clone():
    mc = MetricCollection({"a": TorchSum()}, prefix="pre_", postfix="_post")
    mc.update(torch.tensor(1.0))
    assert list(mc.compute()) == ["pre_a_post"]
    assert list(mc.keys()) == ["pre_a_post"] and list(mc.keys(keep_base=True)) == ["a"]
    assert list(mc.clone(prefix="new_").keys()) == ["new_a_post"]
    assert list(mc.clone(postfix="_x").keys()) == ["pre_a_x"]
    assert "prefix=pre_" in repr(mc) and "(a): TorchSum()" in repr(mc)


def test_forward_returns_batch_values_like_the_jax_package():
    jm, tm = JaxCollection({"a": DummyMetricSum(), "b": DummyMetricDiff()}), MetricCollection(
        {"a": TorchSum(), "b": TorchDiff()}
    )
    for v in (2.0, 3.0):
        _same_results(jm(jnp.asarray(v)), tm(torch.tensor(v)))
    _same_results(jm.compute(), tm.compute())
    assert float(tm.compute()["a"]) == 5.0


def test_reset():
    mc = MetricCollection({"a": TorchSum()})
    mc.update(torch.tensor(2.0))
    mc.reset()
    assert float(mc["a"].x) == 0.0 and mc["a"]._update_count == 0


def test_multioutput_flattened():
    jm, tm = JaxCollection({"multi": DummyMetricMultiOutput()}), MetricCollection({"multi": TorchMultiOutput()})
    jm.update(jnp.asarray(2.0))
    tm.update(torch.tensor(2.0))
    _same_results(jm.compute(), tm.compute())


def test_compute_group_detection():
    jm = JaxCollection([JaxStatsA(), JaxStatsB(), JaxOther()], compute_groups=True)
    tm = MetricCollection([TorchStatsA(), TorchStatsB(), TorchOther()], compute_groups=True)
    for mc in (jm, tm):
        assert not mc._groups_checked
    x = np.asarray([1.0, 2.0, 3.0], np.float32)
    jm.update(jnp.asarray(x))
    tm.update(torch.from_numpy(x))
    assert tm._groups_checked
    assert tm.compute_groups == jm.compute_groups == {0: ["StatsA", "StatsB"], 1: ["Other"]}
    jm.update(jnp.asarray(x))  # only the group leaders
    tm.update(torch.from_numpy(x))
    assert tm["StatsB"]._update_count == 1  # the member waits for its leader's state
    jres, tres = jm.compute(), tm.compute()
    _same_results(jres, tres)
    assert float(tres["StatsA"]) == 2.0 and float(tres["StatsB"]) == 24.0
    assert tm["StatsB"]._update_count == 2 and tm["StatsB"].total is tm["StatsA"].total


def test_explicit_compute_groups():
    tm = MetricCollection(
        [TorchStatsA(), TorchStatsB(), TorchOther()],
        compute_groups=[["StatsA", "StatsB"], ["Other"]],
    )
    assert tm._groups_checked  # given groups: no comparison
    x = torch.tensor([2.0, 4.0])
    tm.update(x)
    tm.update(x)
    out = tm.compute()
    assert float(out["StatsA"]) == 3.0 and float(out["Other"]) == 64.0
    assert tm["StatsB"]._update_count == 2 and float(out["StatsB"]) == 24.0


def test_compute_groups_disabled_matches():
    x = torch.tensor([1.0, 5.0])
    on = MetricCollection([TorchStatsA(), TorchStatsB()], compute_groups=True)
    off = MetricCollection([TorchStatsA(), TorchStatsB()], compute_groups=False)
    for _ in range(3):
        on.update(x)
        off.update(x)
    assert off.compute_groups == {} and len(on.compute_groups) == 1
    _same_port_results(on.compute(), off.compute())


def _suite(mod, **dev):
    return mod.MetricCollection(
        {"acc": mod.Accuracy(num_classes=3, **dev), "f1": mod.F1Score(num_classes=3, average="macro", **dev),
         "cm": mod.ConfusionMatrix(num_classes=3, **dev)},
        compute_groups=False,
    )


def test_pure_update_merge_and_compute_match_the_stateful_path():
    preds, target = torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.3, 0.4, 0.3]]), torch.tensor(
        [0, 1, 2, 2]
    )
    stateful = _suite(metrics_tpu_torch, device="cpu")
    stateful.update(preds, target)
    stateful.update(preds, target)
    pure = _suite(metrics_tpu_torch, device="cpu")
    one = pure.pure_update(pure.state(), preds, target)
    assert all(m._update_count == 0 for m in pure.values())  # the members are untouched
    two = pure.pure_update(one, preds, target)
    _same_port_results(stateful.compute(), pure.pure_compute(two))
    merged = pure.pure_merge(one, one, counts={"acc": 2, "f1": 2, "cm": 2})
    _same_port_results(stateful.compute(), pure.pure_compute(merged))

    pure.load_pure_state(two)  # pure_update has set the members' input mode, as in the JAX test
    _same_port_results(stateful.compute(), pure.compute())
    assert pure["acc"]._update_count == 1
    pure.load_pure_state(two, increment=True)
    assert pure["acc"]._update_count == 2


def test_state_and_state_dict_give_members_their_leaders_state():
    preds, target = torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1]]), torch.tensor([0, 1])

    def make():
        return MetricCollection([
            metrics_tpu_torch.Accuracy(num_classes=3, average="macro", device="cpu"),
            metrics_tpu_torch.F1Score(num_classes=3, average="macro", device="cpu"),
        ])

    mc = make()
    mc.persistent(True)
    mc.update(preds, target)  # the groups merge here
    mc.update(preds, target)  # only the leader
    states = mc.state()
    assert torch.equal(states["Accuracy"]["tp"], states["F1Score"]["tp"]) and int(states["F1Score"]["tp"].sum()) == 4
    states["F1Score"]["tp"] += 1  # a copy: the members keep theirs
    assert int(mc["F1Score"].tp.sum()) == 4
    sd = mc.state_dict()
    mc2 = make()
    mc2.load_state_dict(sd)
    _same_port_results(mc.compute(), mc2.compute())


@pytest.mark.parametrize(
    "metrics, expected_groups",
    [
        (lambda m, **d: [m.Accuracy(num_classes=3, **d), m.Precision(num_classes=3, **d), m.Recall(num_classes=3, **d)],
         [{"Accuracy", "Precision", "Recall"}]),
        (lambda m, **d: [m.Precision(num_classes=3, **d), m.Recall(num_classes=3, **d), m.ConfusionMatrix(num_classes=3, **d)],
         [{"Precision", "Recall"}, {"ConfusionMatrix"}]),
        (lambda m, **d: [m.Accuracy(num_classes=3, average="macro", **d), m.F1Score(num_classes=3, average="macro", **d)],
         [{"Accuracy", "F1Score"}]),
        (lambda m, **d: {"micro": m.Accuracy(num_classes=3, average="micro", **d),
                         "macro": m.Accuracy(num_classes=3, average="macro", **d)},
         [{"micro"}, {"macro"}]),
        (lambda m, **d: _imagenet_list(m, 3, **d),
         [{"Accuracy", "Precision", "Recall", "F1Score", "FBetaScore", "Specificity"}, {"HammingDistance"},
          {"ConfusionMatrix", "CohenKappa", "MatthewsCorrCoef", "JaccardIndex"}]),
        (lambda m, **d: {"pr": m.PrecisionRecallCurve(num_classes=3, **d), "ap": m.AveragePrecision(num_classes=3, **d)},
         [{"ap", "pr"}]),
    ],
    ids=["stat-scores", "stat-scores-and-confmat", "macro", "same-class-other-args", "imagenet-collection",
         "curve-list-states"],
)
def test_real_metric_compute_group_matrix(metrics, expected_groups):
    """The groups equal the JAX package's; grouped values equal ungrouped ones and the JAX package's."""
    jm = JaxCollection(metrics(metrics_tpu), compute_groups=True)
    tm = MetricCollection(metrics(metrics_tpu_torch, device="cpu"), compute_groups=True)
    off = MetricCollection(metrics(metrics_tpu_torch, device="cpu"), compute_groups=False)
    batches = [_scores(16, 3, seed) for seed in (0, 1, 2)]
    for preds, target in batches:
        (jp, tp), (jt, tt) = _pair(preds), _pair(target)
        jm.update(jp, jt)
        tm.update(tp, tt)
        off.update(tp, tt)
        assert tm.compute_groups == jm.compute_groups  # same groups, same order, same leaders
    assert _groups(tm) == {frozenset(g) for g in expected_groups}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # both warn about classes absent from the curve inputs
        jres, tres, ores = jm.compute(), tm.compute(), off.compute()
    _same_port_results(tres, ores)
    _same_results(jres, tres)
    for name in jm.keys(keep_base=True):
        _assert_states(jm[name], tm[name])


def test_batched_leader_equality_matches_pairwise():
    mc = MetricCollection([TorchStatsA(), TorchStatsB(), TorchOther()], compute_groups=True)
    for m in mc.values(copy_state=False):
        m.update(torch.tensor([1.0, 2.0, 3.0]))
    equal = mc._batched_leader_equality()
    names = list(mc.keys(keep_base=True))
    for a in names:
        for b in names:
            if a != b:
                assert equal(a, b) == MetricCollection._equal_metric_states(mc[a], mc[b]), (a, b)


def test_batched_leader_equality_fuzz():
    """The batched table agrees with the pairwise check over random states:
    NaN (never equal), mixed dtypes in one layout, values either side of the
    allclose tolerance, list states and scalar layouts."""
    rng = np.random.RandomState(99)

    class TensorState(Metric):
        full_state_update = False

        def __init__(self, shape, dtype):
            super().__init__(device="cpu")
            self.add_state("a", torch.zeros(shape, dtype=dtype), dist_reduce_fx="sum")
            self.add_state("b", torch.zeros(()), dist_reduce_fx="sum")

        def update(self, *_):
            pass

        def compute(self):
            return self.b

    class ListState(Metric):
        full_state_update = False

        def __init__(self):
            super().__init__(device="cpu")
            self.add_state("vals", [], dist_reduce_fx="cat")

        def update(self, *_):
            pass

        def compute(self):
            return torch.zeros(())

    for trial in range(25):
        mods = {}
        n = rng.randint(2, 7)
        base = rng.randn(3).astype(np.float32)
        for i in range(n):
            kind = rng.randint(0, 4)
            if kind == 0:  # a shared (3,) layout: equal, close, NaN or off
                dtype = torch.float32 if rng.rand() < 0.7 else torch.float64
                m = TensorState((3,), dtype)
                vals = {0: base, 1: base * (1 + 0.5e-5), 2: base + np.nan, 3: base + rng.rand() + 0.1,
                        4: base * (1 + 5e-5)}[rng.randint(0, 5)]
                object.__setattr__(m, "a", torch.tensor(vals, dtype=dtype))
                object.__setattr__(m, "b", torch.tensor(float(rng.randint(0, 2))))
            elif kind == 1:  # a layout of its own
                m = TensorState((rng.randint(4, 7),), torch.float32)
                object.__setattr__(m, "a", torch.tensor(rng.randn(m.a.shape[0]), dtype=torch.float32))
            elif kind == 2:  # list states of 0 to 2 elements
                m = ListState()
                object.__setattr__(m, "vals", [torch.tensor(base if rng.rand() < 0.5 else rng.randn(3),
                                                            dtype=torch.float32) for _ in range(rng.randint(0, 3))])
            else:  # a scalar layout
                m = TensorState((), torch.float32)
                object.__setattr__(m, "b", torch.tensor(float(rng.randint(0, 2))))
            mods[f"m{i}"] = m
        mc = MetricCollection(mods, compute_groups=True)
        equal = mc._batched_leader_equality()
        for a in mods:
            for b in mods:
                if a != b:
                    assert equal(a, b) == MetricCollection._equal_metric_states(mods[a], mods[b]), (trial, a, b)


def test_group_detection_reads_the_device_once(monkeypatch):
    """All buckets' tables come to the host in one read."""
    mc = MetricCollection(_imagenet_list(metrics_tpu_torch, 5, device="cpu"))
    preds, target = _scores(32, 5, 3)
    for m in mc.values(copy_state=False):
        m.update(torch.from_numpy(preds), torch.from_numpy(target))
    reads = []
    real_cpu = torch.Tensor.cpu

    def counting_cpu(self, *args, **kwargs):
        reads.append(self.shape)
        return real_cpu(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)
    equal = mc._batched_leader_equality()
    assert len(reads) == 1 and reads[0] == (6 * 6 + 4 * 4,)
    assert equal("Accuracy", "Specificity") and equal("CohenKappa", "JaccardIndex")
    assert not equal("Accuracy", "HammingDistance") and not equal("Accuracy", "ConfusionMatrix")


def test_update_compute_forward_update_compute_equals_ungrouped():
    """Members share their leader's tensors after a compute; a forward then
    updates every member and the next update only the leaders. Nothing may be
    counted twice: the values equal a ``compute_groups=False`` collection."""
    on = MetricCollection(_imagenet_list(metrics_tpu_torch, C, device="cpu"))
    off = MetricCollection(_imagenet_list(metrics_tpu_torch, C, device="cpu"), compute_groups=False)
    batches = [tuple(torch.from_numpy(x) for x in _scores(20, C, seed)) for seed in range(4)]
    on.update(*batches[0])
    off.update(*batches[0])
    _same_port_results(on.compute(), off.compute())
    assert on["Precision"].tp is on["Accuracy"].tp  # the refs are shared now
    _same_port_results(on(*batches[1]), off(*batches[1]))
    on.update(*batches[2])
    off.update(*batches[2])
    _same_port_results(on.compute(), off.compute())
    _same_port_results(on(*batches[3]), off(*batches[3]))
    _same_port_results(on.compute(), off.compute())
    for name in on.keys(keep_base=True):
        for key in on[name]._defaults:
            assert torch.equal(getattr(on[name], key), getattr(off[name], key)), (name, key)
        assert on[name]._update_count == off[name]._update_count == 4


def test_update_compute_update_compute_equals_ungrouped():
    """A member's memoised compute goes when it takes its leader's new state.
    The JAX package keeps it (ROADMAP.md, Queue C): its grouped F1 after the
    second update repeats the first value."""
    def members(mod, **d):
        return [mod.Accuracy(num_classes=3, average="macro", **d), mod.F1Score(num_classes=3, average="macro", **d)]

    batches = [_scores(16, 3, seed) for seed in (0, 1)]
    jax_on, jax_off = JaxCollection(members(metrics_tpu)), JaxCollection(members(metrics_tpu), compute_groups=False)
    on = MetricCollection(members(metrics_tpu_torch, device="cpu"))
    results = []
    for preds, target in batches:
        (jp, tp), (jt, tt) = _pair(preds), _pair(target)
        jax_on.update(jp, jt)
        jax_off.update(jp, jt)
        on.update(tp, tt)
        results.append((jax_on.compute(), jax_off.compute(), on.compute()))
    for _, jax_ungrouped, port in results:
        _same_results(jax_ungrouped, port)
    # the reference's fault, as found: its grouped F1 did not move
    assert float(results[1][0]["F1Score"]) == float(results[0][0]["F1Score"]) != float(results[1][1]["F1Score"])


def test_members_without_state_are_never_merged():
    """``a = P + R`` and ``c = P * R`` hold no state: the JAX package merges
    them and then updates only ``a``'s operands, so its grouped ``c`` is 1.0;
    ungrouped (and in the port, grouped or not) it is 0.45."""
    def members(mod, **d):
        return {"a": mod.Precision(**d) + mod.Recall(**d), "c": mod.Precision(**d) * mod.Recall(**d)}

    batches = [(np.asarray([0.2, 0.8, 0.6], np.float32), np.asarray([0, 1, 1])),
               (np.asarray([0.9, 0.8, 0.1, 0.7], np.float32), np.asarray([0, 0, 1, 1]))]
    jax_on, jax_off = JaxCollection(members(metrics_tpu)), JaxCollection(members(metrics_tpu), compute_groups=False)
    on = MetricCollection(members(metrics_tpu_torch, device="cpu"))
    off = MetricCollection(members(metrics_tpu_torch, device="cpu"), compute_groups=False)
    for preds, target in batches:
        (jp, tp), (jt, tt) = _pair(preds), _pair(target)
        for mc, p, t in ((jax_on, jp, jt), (jax_off, jp, jt), (on, tp, tt), (off, tp, tt)):
            mc.update(p, t)
    assert _groups(on) == {frozenset({"a"}), frozenset({"c"})}
    assert _groups(jax_on) == {frozenset({"a", "c"})}
    _same_results(jax_off.compute(), on.compute())
    _same_port_results(on.compute(), off.compute())
    np.testing.assert_allclose(float(on.compute()["c"]), 0.45, rtol=RTOL)
    assert float(jax_on.compute()["c"]) == 1.0
    assert not MetricCollection._equal_metric_states(on["a"], on["c"])


def test_stat_scores_and_confusion_counts_run_once_a_group_after_the_first_update(monkeypatch):
    """The first update runs every member, each later one each group leader:
    "members + (updates - 1) x groups" calls of each count function. On the
    card each call is one kernel launch (``tests/test_torch_cuda.py``)."""
    calls = {"stat_scores": 0, "confusion_matrix": 0}
    stat_scores_module = importlib.import_module("metrics_tpu_torch.functional.classification.stat_scores")
    confusion_module = importlib.import_module("metrics_tpu_torch.functional.classification.confusion_matrix")

    def counting(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)

        return wrapped

    monkeypatch.setattr(stat_scores_module, "stat_scores_counts",
                        counting("stat_scores", stat_scores_module.stat_scores_counts))
    monkeypatch.setattr(confusion_module, "confusion_matrix_counts",
                        counting("confusion_matrix", confusion_module.confusion_matrix_counts))
    batches = [tuple(torch.from_numpy(x) for x in _scores(24, 10, seed)) for seed in range(5)]
    for groups, expected in ((True, (6 + 4, 4 + 4)), (False, (6 * 5, 4 * 5))):
        calls.update(stat_scores=0, confusion_matrix=0)
        mc = MetricCollection(_imagenet_list(metrics_tpu_torch, 10, device="cpu"), compute_groups=groups)
        for preds, target in batches:
            mc.update(preds, target)
        assert (calls["stat_scores"], calls["confusion_matrix"]) == expected


def test_collection_state_dict_jax_to_port_to_jax():
    """A JAX collection's payload (``<member>.<state>``, one checksum pass)
    loads into the port's collection, and the port's back into JAX's."""
    batches = [_scores(32, 5, seed) for seed in (4, 5, 6)]
    jm = JaxCollection(_imagenet_list(metrics_tpu, 5), prefix="val_")
    jm.persistent(True)
    for preds, target in batches[:2]:
        jm.update(*(jnp.asarray(x) for x in (preds, target)))
    payload = jm.state_dict()
    assert "Accuracy.tp" in payload and "__checksum__::ConfusionMatrix.confmat" in payload

    tm = MetricCollection(_imagenet_list(metrics_tpu_torch, 5, device="cpu"), prefix="val_")
    tm.persistent(True)
    load_jax_state_dict(tm, payload)
    for name in jm.keys(keep_base=True):
        _assert_states(jm[name], tm[name])
    _same_results(jm.compute(), tm.compute())

    (jp, tp), (jt, tt) = (_pair(x) for x in batches[2])
    jm.update(jp, jt)
    tm.update(tp, tt)
    back = to_jax_state_dict(tm)
    jm2 = JaxCollection(_imagenet_list(metrics_tpu, 5), prefix="val_")
    jm2.persistent(True)
    jm2.load_state_dict(back)  # verifies the port's checksums
    _same_results(jm2.compute(), tm.compute())
    jm.state()  # the JAX members take their leaders' state (its compute would keep a stale memo)
    for name in jm.keys(keep_base=True):
        _assert_states(jm[name], tm[name])
        _assert_states(jm2[name], tm[name])
    assert {k: v for k, v in jm.state_dict().items() if k.startswith("__checksum__")} == {
        k: v for k, v in tm.state_dict().items() if k.startswith("__checksum__")
    }


def test_corrupted_collection_payload_is_refused():
    tm = MetricCollection(_imagenet_list(metrics_tpu_torch, 5, device="cpu"))
    tm.persistent(True)
    tm.update(*(torch.from_numpy(x) for x in _scores(16, 5, 0)))
    payload = tm.state_dict()
    payload["Recall.tp"] = payload["Recall.tp"].clone()
    payload["Recall.tp"][0] += 1
    fresh = MetricCollection(_imagenet_list(metrics_tpu_torch, 5, device="cpu"))
    with pytest.raises(StateCorruptionError, match="'Recall.tp'"):
        fresh.load_state_dict(payload)
    assert int(fresh["Accuracy"].tp.sum()) == 0


def test_memory_snapshot_matches_the_jax_package():
    jm = JaxCollection(_imagenet_list(metrics_tpu, 5))
    tm = MetricCollection(_imagenet_list(metrics_tpu_torch, 5, device="cpu"))
    preds, target = _scores(16, 5, 1)
    jm.update(jnp.asarray(preds), jnp.asarray(target))
    tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    for top_n in (3, 100):
        assert tm.memory_snapshot(top_n) == jm.memory_snapshot(top_n)
    assert tm["Accuracy"].memory_snapshot() == jm["Accuracy"].memory_snapshot()


def test_memory_snapshot_of_list_states_matches_the_jax_package():
    """A list state is one leaf summing its elements, ``empty-list`` before any update."""
    def members(mod, **d):
        return {"pr": mod.PrecisionRecallCurve(num_classes=3, **d), "acc": mod.Accuracy(num_classes=3, **d)}

    jm, tm = JaxCollection(members(metrics_tpu)), MetricCollection(members(metrics_tpu_torch, device="cpu"))
    assert tm.memory_snapshot() == jm.memory_snapshot()
    for seed in (0, 1):
        (jp, tp), (jt, tt) = (_pair(x) for x in _scores(16, 3, seed))
        jm.update(jp, jt)
        tm.update(tp, tt)
        assert tm.memory_snapshot(top_n=2) == jm.memory_snapshot(top_n=2)
        assert tm["pr"].memory_snapshot() == jm["pr"].memory_snapshot()


def test_dtype_device_and_mapping_helpers():
    tm = MetricCollection({"s": TorchSum(), "acc": metrics_tpu_torch.Accuracy(num_classes=3, device="cpu")})
    assert tm.float() is tm and tm.double() is tm and tm.half() is tm and tm.type(torch.float64) is tm
    assert tm["s"].x.dtype == torch.float32
    tm.set_dtype(torch.float64)
    assert tm["s"].x.dtype == torch.float64 and tm["acc"].tp.dtype == torch.int32  # counts stay int32
    assert tm.to("cpu") is tm and tm["s"].device == torch.device("cpu")
    assert [k for k, _ in tm.items()] == ["acc", "s"] and list(tm.values()) == [tm["acc"], tm["s"]]
    with pytest.raises(AttributeError):
        tm.missing


def test_kwargs_are_routed_to_the_members_that_take_them():
    class TakesY(TorchSum):
        def update(self, y):
            self.x = self.x + 10 * y

    mc = MetricCollection({"x": TorchSum(), "y": TakesY()}, compute_groups=False)
    mc.update(x=torch.tensor(1.0), y=torch.tensor(2.0))
    mc.update(x=torch.tensor(1.0), y=torch.tensor(2.0))
    assert float(mc["x"].x) == 2.0 and float(mc["y"].x) == 40.0
    assert mc._filter_kwargs_cache == {("x", ("x", "y")): ("x",), ("y", ("x", "y")): ("y",)}


@pytest.mark.parametrize(
    "call,item",
    [
        # the sync is ported (ROADMAP.md, Queue A item 5): one process, so each is a no-op or an empty count
        (lambda: MetricCollection([TorchSum()], sync_precision="int8")["TorchSum"].sync_precision, "int8"),
        (lambda: MetricCollection([TorchSum()]).sync(), None),
        (lambda: MetricCollection([TorchSum()]).unsync(), None),
        (lambda: _entered(MetricCollection([TorchSum()]).sync_context()), True),
        (lambda: _synced_alone(MetricCollection([TorchSum()])), 1.0),
        (lambda: MetricCollection([TorchSum()]).sync_stats, {"collectives": 0, "buckets": 0, "bytes_on_wire": 0}),
        (lambda: MetricCollection([TorchSum()]).telemetry_snapshot(), "item 10"),
    ],
    ids=["sync_precision", "sync", "unsync", "sync_context", "pure_sync", "sync_stats", "telemetry_snapshot"],
)
def test_unported_parts_raise_naming_the_roadmap_item(call, item):
    """A part not ported yet raises naming its ROADMAP.md item; the sync's
    parts are ported and give a one-process collection its own state."""
    if item == "item 10":
        with pytest.raises(NotImplementedError, match=f"ROADMAP.md, Queue A {item}"):
            call()
    else:
        assert call() == item


def _entered(context):
    with context:
        return True


def _synced_alone(mc):
    mc.update(torch.tensor(1.0))
    return float(mc.pure_sync(mc.state())["TorchSum"]["x"])


def test_fused_update_none_and_false_take_the_eager_loop():
    for fused in (None, False):
        mc = MetricCollection([TorchStatsA(), TorchStatsB()], fused_update=fused)
        mc.update(torch.tensor([1.0, 3.0]))
        assert float(mc.compute()["StatsA"]) == 2.0


def _depth_members(mod, **dev):
    """The NYU-Depth v2 evaluation collection of ``chip_smoke.py``'s slice 11."""
    return {
        "mse": mod.MeanSquaredError(**dev), "rmse": mod.MeanSquaredError(squared=False, **dev),
        "mae": mod.MeanAbsoluteError(**dev), "msle": mod.MeanSquaredLogError(**dev),
        "abs_rel": mod.MeanAbsolutePercentageError(**dev), "r2": mod.R2Score(**dev),
        "explained_variance": mod.ExplainedVariance(**dev),
    }


def test_depth_collection_compute_groups_and_values_equal_to_jax():
    """MSE and RMSE share their states: the JAX package's six groups, its
    values (rtol 1e-5: float32 sums in another order), and the fused update
    bit-equal to the eager loop."""
    rng = np.random.RandomState(31)
    jm = JaxCollection(_depth_members(metrics_tpu), prefix="depth_")
    tm = MetricCollection(_depth_members(metrics_tpu_torch, device="cpu"), prefix="depth_")
    fused = MetricCollection(_depth_members(metrics_tpu_torch, device="cpu"), prefix="depth_", fused_update=True)
    for _ in range(3):
        target = rng.uniform(0.5, 10.0, size=300).astype(np.float32)
        preds = (target * np.exp(0.1 * rng.randn(300))).astype(np.float32)
        (jp, tp), (jt, tt) = _pair(preds), _pair(target)
        jm.update(jp, jt)
        tm.update(tp, tt)
        fused.update(tp, tt)
        assert tm.compute_groups == jm.compute_groups
    assert tm.compute_groups == {0: ["abs_rel"], 1: ["explained_variance"], 2: ["mae"], 3: ["mse", "rmse"],
                                 4: ["msle"], 5: ["r2"]}
    assert fused.dispatch_stats["dispatches"] == 3 and fused.dispatch_stats["demotions"] == 0
    jres, tres = jm.compute(), tm.compute()
    assert list(jres) == list(tres)
    for key in jres:
        np.testing.assert_allclose(tres[key].numpy(), np.asarray(jres[key]), rtol=1e-5, atol=0)
    _same_port_results(tres, fused.compute())
    for name in jm.keys(keep_base=True):
        for key in jm[name]._defaults:
            ref, got = np.asarray(getattr(jm[name], key)), getattr(tm[name], key).numpy()
            assert got.dtype == ref.dtype and got.shape == ref.shape, (name, key)
            if key == "total" and name != "abs_rel":  # int32 counts; MAPE's total is float32
                np.testing.assert_array_equal(got, ref)
            else:
                np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0)
