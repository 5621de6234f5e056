"""``MetricCollection``: port of ``metrics_tpu/collections.py``, the eager core.

Metrics that share a call pattern are updated, computed and checkpointed
together. Compute groups merge members whose states are equal after the
first update: from then on ``update`` runs one member of each group (its
leader) and the others take the leader's state before they compute. So an
``Accuracy``, ``Precision``, ``Recall`` and ``F1Score`` of one averaging
make one ``stat_scores`` launch a batch between them, and the
confusion-matrix family one ``confusion_matrix`` launch.

Group detection compares every group leader with every other of the same
state layout in one pass: the comparisons are queued on the device and
their results come back to the host in one read.

The fused update and forward (``metrics_tpu/collections.py:188-531``):
with ``fused_update`` on, the whole collection's update, or its forward, is
one program of the fast-dispatch engine (:mod:`metrics_tpu_torch.dispatch`;
on the card one CUDA graph a shape), with every member's state leaves
crossing as one flat tuple. As in the JAX package the program advances
**every** member and does not consult the compute groups; a CUDA graph has
no common-subexpression elimination, so the work the groups would share
runs once a member on the device. ``scan_update`` folds a stack of batches
as one program; ``dispatch_stats`` and ``forward_stats`` count the fused
path's programs. Failures degrade to the eager loop through the resilience
policy (:mod:`metrics_tpu_torch.resilience`).

Sync (``metrics_tpu/collections.py:659, 710-867, 935``): ``compute`` syncs
the whole collection once, in one bucket pass of the sync engine across every
compute-group leader (:mod:`metrics_tpu_torch.sync_engine`); each leader then
syncs its remaining list and ragged states, and the followers take their
leader's synced state with no collective. ``sync``, ``unsync``,
``sync_context``, ``pure_sync``, ``sync_precision`` and ``sync_stats`` as in
the JAX package.

Telemetry (``metrics_tpu/collections.py:222, 686-707, 758``): a collection
that can never fuse emits one ``degrade`` span with the cause
``unfusable``, a sync a ``sync`` span, and :meth:`telemetry_snapshot`
merges the fused path's stats with each member's. The JAX package's legacy
fused forward (a ``jax.jit`` step, ``forward:jit``) has no counterpart: with
the forward engine switched off the collection runs its eager loop, whose
members emit their own spans.
"""
import functools
from collections import OrderedDict
from contextlib import contextmanager
from copy import deepcopy
from typing import Any, Callable, Dict, Generator, Hashable, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch import resilience, sync_engine, telemetry
from metrics_tpu_torch.dispatch import FastDispatcher, engine_owned, fast_dispatch_enabled, launch_kind
from metrics_tpu_torch.forward_engine import fused_forward_enabled, make_collection_forward_factories, padded_mask
from metrics_tpu_torch.metric import Metric, _raise_if_list_state, _scan_fold, _split_static_kwargs, aot_cache_stats
from metrics_tpu_torch.parallel.dist_env import DistEnv, default_env, group_env
from metrics_tpu_torch.utilities.exceptions import MetricsUserError
from metrics_tpu_torch.utilities.checks import tracing
from metrics_tpu_torch.utilities.checksums import attach_checksums, verify_checksums
from metrics_tpu_torch.utilities.data import _flatten_dict, _squeeze_if_scalar
from metrics_tpu_torch.utilities.prints import rank_zero_debug, rank_zero_warn


def _comparable(values: Sequence[Tensor]) -> Tensor:
    """``values`` flattened and stacked as (k, n) in one floating dtype, as
    ``jnp.isclose`` compares them: promoted together, then integers and bools
    as float32."""
    dtype = functools.reduce(torch.promote_types, (v.dtype for v in values))
    flat = torch.stack([v.reshape(-1).to(dtype) for v in values])
    return flat if dtype.is_floating_point or dtype.is_complex else flat.to(torch.float32)


def _allclose(a: Tensor, b: Tensor) -> bool:
    """``jnp.allclose(a, b)``: rtol 1e-5, atol 1e-8, NaN never equal."""
    a, b = _comparable((a, b))
    return bool(torch.isclose(a, b).all())


def _pairwise_equal(leaf_groups: List[Tuple[Tensor, ...]]) -> Tensor:
    """(k, k) state equality of a bucket of k leaders, on their device.

    ``leaf_groups`` holds one tuple a state leaf, with that leaf of each of
    the k leaders. Each leaf is promoted on its own, as the JAX package
    promotes it; the leaves of one comparison dtype are then laid side by
    side as one (k, n) matrix and compared in one pass, so the launches do
    not grow with the number of leaves. Two leaders are equal where every
    element is close.
    """
    by_dtype: Dict[torch.dtype, List[Tensor]] = {}
    for group in leaf_groups:
        flat = _comparable(group)
        by_dtype.setdefault(flat.dtype, []).append(flat)
    out = None
    for flats in by_dtype.values():
        flat = flats[0] if len(flats) == 1 else torch.cat(flats, dim=1)
        mat = torch.isclose(flat[:, None, :], flat[None, :, :]).all(dim=-1)
        out = mat if out is None else out & mat
    return out


class MetricCollection:
    """A dict of metrics updated and computed together.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MaxMetric, MetricCollection, SumMetric
        >>> mc = MetricCollection([SumMetric(device="cpu"), MaxMetric(device="cpu")])
        >>> mc.update(torch.tensor([1.0, 2.0]))
        >>> {k: float(v) for k, v in mc.compute().items()}
        {'SumMetric': 3.0, 'MaxMetric': 2.0}

    Args:
        metrics: one metric, a sequence of metrics (their class names become
            the keys) or a dict of metrics (its keys taken sorted).
        additional_metrics: more metrics, where ``metrics`` is one or a sequence.
        prefix / postfix: strings put around every output key.
        compute_groups: ``True`` (found after the first update), ``False``
            (off), or the groups as a list of lists of keys.
        fused_update: ``True``: the fused update and forward, one program
            for the whole collection; ``False``: the eager loop, one member
            (or one group leader) at a time; ``None``: fused where the members
            live on a CUDA device, eager on the CPU.
        sync_precision: ``"int8"`` gives every member that chose none of its
            own the quantised sync wire.
    """

    def __init__(
        self,
        metrics: Union[Metric, Sequence[Metric], Dict[str, Metric]],
        *additional_metrics: Metric,
        prefix: Optional[str] = None,
        postfix: Optional[str] = None,
        compute_groups: Union[bool, List[List[str]]] = True,
        fused_update: Optional[bool] = None,
        sync_precision: Optional[str] = None,
    ) -> None:
        self._modules: "OrderedDict[str, Metric]" = OrderedDict()
        self.prefix = self._check_arg(prefix, "prefix")
        self.postfix = self._check_arg(postfix, "postfix")
        self._enable_compute_groups = compute_groups
        self._groups_checked: bool = False
        self._groups: Dict[int, List[str]] = {}
        self._fused_update = fused_update
        # set when this collection can never fuse (or the policy benched the fused path for good)
        self._fuse_failed = False
        self._fuse_resilience = resilience.ResiliencePolicy()
        self._dispatcher: Optional[FastDispatcher] = None
        self._dispatch_stats: Dict[str, int] = {"dispatches": 0, "retraces": 0}
        self._forward_stats: Dict[str, Any] = {"launches": 0, "retraces": 0, "engine_us": 0.0}
        # the kwargs a member accepts, memoised by (member, kwarg names)
        self._filter_kwargs_cache: Dict[Tuple[str, Tuple[str, ...]], Tuple[str, ...]] = {}
        # the collection's own sync counters, and the members its sync touched (with their flags to restore)
        self._sync_stats: Dict[str, int] = {"collectives": 0, "buckets": 0, "bytes_on_wire": 0}
        self._synced_members: Optional[List[Tuple[Metric, bool, bool]]] = None

        self.add_metrics(metrics, *additional_metrics)
        if sync_precision is not None:
            if sync_precision != "int8":
                raise ValueError(
                    f'Expected keyword argument `sync_precision` to be None or "int8" but got {sync_precision}'
                )
            for m in self._modules.values():
                if m.sync_precision is None:
                    m.sync_precision = sync_precision

    def __getstate__(self) -> Dict[str, Any]:
        # the engine's graphs and buffers are made again at the next fused call
        return {k: v for k, v in self.__dict__.items() if k != "_dispatcher"}

    def __setstate__(self, state: Dict[str, Any]) -> None:
        self.__dict__.update(state)
        self._dispatcher = None
        self._filter_kwargs_cache = {}

    # --------------------------------------------------------------- mapping
    def __getitem__(self, key: str) -> Metric:
        return self._modules[key]

    def __setitem__(self, key: str, value: Metric) -> None:
        self._modules[key] = value
        self._filter_kwargs_cache.clear()
        self._dispatcher = None  # its programs take the old members' states

    def __contains__(self, key: str) -> bool:
        return key in self._modules

    def __len__(self) -> int:
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules)

    def __getattr__(self, name: str) -> Any:
        modules = self.__dict__.get("_modules", {})
        if name in modules:
            return modules[name]
        raise AttributeError(f"{type(self).__name__!r} object has no attribute {name!r}")

    def values(self, copy_state: bool = True) -> Iterable[Metric]:
        """The members; with ``copy_state`` each group member first takes its leader's state."""
        if copy_state:
            self._compute_groups_create_state_ref()
        return self._modules.values()

    # ----------------------------------------------------------------- calls
    def _filtered_kwargs(self, name: str, metric: Metric, kwargs: Dict[str, Any]) -> Dict[str, Any]:
        """``metric._filter_kwargs(**kwargs)``, with the accepted names memoised."""
        if not kwargs:
            return kwargs
        cache_key = (name, tuple(sorted(kwargs)))
        keep = self._filter_kwargs_cache.get(cache_key)
        if keep is None:
            keep = tuple(metric._filter_kwargs(**kwargs))
            self._filter_kwargs_cache[cache_key] = keep
        return {k: kwargs[k] for k in keep}

    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """Every member's ``forward``: the batch values, and the batch accumulated."""
        if self._fusion_enabled:
            fused = self._try_fused_forward(*args, **kwargs)
            if fused is not None:
                return fused
        res = {k: m(*args, **self._filtered_kwargs(k, m, kwargs)) for k, m in self.items(keep_base=True)}
        res = _flatten_dict(res)
        return {self._set_name(k): v for k, v in res.items()}

    __call__ = forward

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Update every member, or once the groups are formed each group's leader."""
        if self._fusion_enabled and self._try_fused_update(*args, **kwargs):
            return
        if self._groups_checked:
            for cg in self._groups.values():
                m0 = self._modules[cg[0]]
                m0.update(*args, **self._filtered_kwargs(cg[0], m0, kwargs))
        else:
            for name, m in self.items(keep_base=True):
                m.update(*args, **self._filtered_kwargs(name, m, kwargs))
            if self._enable_compute_groups:
                self._merge_compute_groups()
                self._groups_checked = True

    def compute(self) -> Dict[str, Any]:
        """Every member's value; group members take their leader's state first.
        Across processes the whole collection syncs first, in one bucket pass
        (:meth:`sync_context`); inside a sync the caller holds, it stays synced."""
        already_synced = self._synced_members is not None
        with telemetry.profiler_range("metrics_tpu.MetricCollection.compute"), self.sync_context(
            should_sync=not already_synced, should_unsync=not already_synced
        ):
            self._compute_groups_create_state_ref()
            res = _flatten_dict({k: m.compute() for k, m in self.items(keep_base=True)})
        return {self._set_name(k): v for k, v in res.items()}

    def reset(self) -> None:
        with telemetry.profiler_range("metrics_tpu.MetricCollection.reset"):
            for m in self._modules.values():
                m.reset()

    # ---------------------------------------------------------- fused calls
    @property
    def _device(self) -> torch.device:
        return next(iter(self._modules.values())).device

    @property
    def _fusion_enabled(self) -> bool:
        """``fused_update`` resolved: ``None`` is fused on a CUDA device, where
        a member's eager update is mostly host time, and eager on the CPU,
        where the eager loop keeps the checks that read values."""
        if self._fuse_failed:
            return False
        if self._fused_update is None:
            return self._device.type == "cuda"
        return bool(self._fused_update)

    def _fuse_fallback(self, what: str, reason: Union[str, Exception]) -> None:
        if isinstance(reason, Exception):
            # a failed engine call: eager serves it, the fused path cools down (for good if unsupported)
            resilience.record_degrade("MetricCollection", what, reason, self._fuse_resilience)
            if self._fuse_resilience.permanent:
                self._fuse_failed = True
            msg = (
                f"MetricCollection could not fuse `{what}` ({type(reason).__name__}: {reason}); falling back to"
                " eager dispatch"
                + ("." if self._fuse_failed else f" (cooldown {self._fuse_resilience.cooldown} calls).")
            )
        else:
            # this collection or its inputs can never fuse
            self._fuse_failed = True
            telemetry.emit("degrade", "MetricCollection", what, cause="unfusable", permanent=True)
            msg = f"MetricCollection could not fuse `{what}` ({reason}); falling back to eager dispatch."
        # an explicit fused_update=True hears of it; the default falls back quietly
        (rank_zero_warn if self._fused_update is True else rank_zero_debug)(msg)

    def _fusable(self, args: tuple, kwargs: dict) -> bool:
        # the members are checked before the engine is built; changing them drops it (__setitem__)
        for m in self._modules.values() if self._dispatcher is None else ():
            if m.compute_on_cpu or m.dist_sync_on_step:
                return False  # a move to the host or a collective each step, which a graph does not hold
            if any(isinstance(d, list) for d in m._defaults.values()):
                return False  # a growing list state changes the program's inputs every step
            if m._children():
                return False  # wrapped metrics hold state outside _defaults
        return all(
            isinstance(x, (Tensor, np.ndarray, np.number, int, float)) and not isinstance(x, bool)
            for x in (*args, *kwargs.values())
        )

    def _layout(self) -> List[Tuple[str, str]]:
        return [(name, key) for name, m in self._modules.items() for key in m._defaults]

    def _make_dispatcher(self) -> FastDispatcher:
        """The fused engine: every member's state crosses as one flat tuple
        of leaves, read and written straight off the members."""
        layout = self._layout()

        def read_leaves() -> Tuple:
            return tuple(getattr(self._modules[name], key) for name, key in layout)

        def write_leaves(leaves: Tuple) -> None:
            for (name, key), leaf in zip(layout, leaves):
                object.__setattr__(self._modules[name], key, leaf)

        def unflatten(leaves: Tuple) -> Dict[str, Dict[str, Any]]:
            states: Dict[str, Dict[str, Any]] = {name: {} for name in self._modules}
            for (name, key), leaf in zip(layout, leaves):
                states[name][key] = leaf
            return states

        def flatten(states: Dict[str, Dict[str, Any]]) -> Tuple:
            return tuple(states[name][key] for name, key in layout)

        def make_update(static: Dict) -> Callable:
            def fn(leaves, *args, **kwargs):
                return flatten(self.pure_update(unflatten(leaves), *args, **kwargs))

            return fn

        def make_masked_update(static: Dict) -> Callable:
            def fn(n_valid, leaves, *args, **kwargs):
                mask = padded_mask(args, kwargs, n_valid)
                states = unflatten(leaves)
                return flatten({
                    name: m._masked_pure_update(states[name], mask, *args, **m._filter_kwargs(**kwargs))
                    for name, m in self.items(keep_base=True)
                })

            return fn

        def make_scan(static: Dict) -> Callable:
            def fn(leaves, *args, **kwargs):
                return flatten(_scan_fold(self.pure_update, unflatten(leaves), args, {**kwargs, **static}))

            return fn

        def masking_ok() -> bool:
            return all(m._masked_update_supported() for m in self._modules.values())

        make_forward, make_masked_forward = make_collection_forward_factories(self, unflatten, flatten)
        return FastDispatcher(
            "MetricCollection",
            self._device,
            read_leaves,
            write_leaves,
            make_update,
            make_masked_update,
            masking_ok=masking_ok,
            stats=self._dispatch_stats,
            make_forward=make_forward,
            make_masked_forward=make_masked_forward,
            forward_stats=self._forward_stats,
            make_scan=make_scan,
        )

    @property
    def dispatch_stats(self) -> Dict[str, Any]:
        """Fused-update counters (``dispatches``, ``retraces``, ``evictions``)
        and the fused path's degradation state."""
        stats: Dict[str, Any] = dict(self._dispatch_stats)
        stats.update(self._fuse_resilience.stats())
        return stats

    @property
    def forward_stats(self) -> Dict[str, Any]:
        """Fused-forward counters (``launches``, ``retraces``, host
        ``engine_us``) and the fused path's degradation state."""
        stats: Dict[str, Any] = dict(self._forward_stats)
        stats.update(self._fuse_resilience.stats())
        return stats

    def _snapshot_members(self) -> Optional[Dict[str, Dict[str, Any]]]:
        """Every member's leaves before a fused call; ``None`` with resilience off."""
        if not resilience.resilience_enabled():
            return None
        return {name: resilience.snapshot_state(m) for name, m in self.items(keep_base=True)}

    def _restore_members(self, snaps: Dict[str, Dict[str, Any]]) -> None:
        for name, m in self.items(keep_base=True):
            resilience.restore_state(m, snaps[name])

    def _verify_members(self, snaps: Dict[str, Dict[str, Any]], where: str) -> None:
        if not resilience.verify_after_call():
            return
        check_values = resilience.verification_enabled()
        for name, m in self.items(keep_base=True):
            resilience.verify_engine_state(m, snaps[name], where=f"{where}:{name}", check_values=check_values)

    def _try_fused_update(self, *args: Any, **kwargs: Any) -> bool:
        if not fast_dispatch_enabled():
            return False  # the kill switch: the eager loop
        if not self._fuse_resilience.allow():
            return False  # cooling down after a failure
        # the engine call's stages begin here: the checks and the snapshot are its preparation
        with telemetry.Stages("MetricCollection", "update", launch_kind("MetricCollection")) as stages:
            if not self._fusable(args, kwargs):
                self._fuse_fallback("update", "unfusable member or non-tensor inputs")
                return False
            # members of a group formed by eager updates take their leader's state first
            self._compute_groups_create_state_ref()
            snap = self._snapshot_members()

            def install() -> None:
                if snap is not None:
                    self._verify_members(snap, "fused-update")
                self._fuse_resilience.note_success()
                for m in self._modules.values():
                    m._update_count += 1
                    m._computed = None
                    m._forward_cache = None
                    m._bump_version()

            try:
                if self._dispatcher is None:
                    self._dispatcher = self._make_dispatcher()
                self._dispatcher.update({}, (), args, kwargs, stages, install)
            except Exception as err:  # noqa: BLE001 -- degrade to the eager loop
                if snap is not None:
                    self._restore_members(snap)
                self._fuse_fallback("update", err)
                return False
        return True

    def _fused_forward_impl(
        self, update: Callable, states: Dict, counts: Dict, *args: Any, **kwargs: Any
    ) -> Tuple[Dict, Dict]:
        """Every member's forward step as pure functions: ``(new states, batch
        values)``. ``update(member, state, *args, **kwargs)`` is a member's
        state step: its ``pure_update``, or the masked program's
        masked update."""
        new_states, batch_vals = {}, {}
        for name, m in self.items(keep_base=True):
            kw = m._filter_kwargs(**kwargs)
            batch_state = update(m, m.default_state(), *args, **kw)
            if m.full_state_update or m.full_state_update is None:
                new_states[name] = update(m, states[name], *args, **kw)
            else:
                new_states[name] = m.pure_merge(states[name], batch_state, count=counts[name])
            batch_vals[name] = _squeeze_if_scalar(m.pure_compute(batch_state))
        return new_states, batch_vals

    def _try_fused_forward(self, *args: Any, **kwargs: Any) -> Optional[Dict[str, Any]]:
        if not (fast_dispatch_enabled() and fused_forward_enabled()):
            return None  # a kill switch: the eager loop
        if not self._fuse_resilience.allow():
            return None
        if not self._fusable(args, kwargs):
            self._fuse_fallback("forward", "unfusable member or non-tensor inputs")
            return None
        self._compute_groups_create_state_ref()
        counts = {name: float(m._update_count + 1) for name, m in self.items(keep_base=True)}
        snap = self._snapshot_members()
        try:
            if self._dispatcher is None:
                self._dispatcher = self._make_dispatcher()
            batch_vals = self._dispatcher.forward(counts, {}, (), args, kwargs)
            if snap is not None:
                self._verify_members(snap, "fused-forward")
        except Exception as err:  # noqa: BLE001 -- degrade to the eager loop
            if snap is not None:
                self._restore_members(snap)
            self._fuse_fallback("forward", err)
            return None
        self._fuse_resilience.note_success()
        for name, m in self.items(keep_base=True):
            m._update_count += 1
            m._computed = None
            m._forward_cache = batch_vals[name]
            m._bump_version()
        res = _flatten_dict(batch_vals)
        return {self._set_name(k): v for k, v in res.items()}

    def scan_update(
        self, states: Dict[str, Dict[str, Any]], *batched_args: Any, **batched_kwargs: Any
    ) -> Dict[str, Dict[str, Any]]:
        """Fold a stack of batches into every member's state as one program
        (on the card one CUDA graph a shape): :meth:`Metric.scan_update` with
        :meth:`pure_update` as the step. Members need fixed-shape states."""
        for name, m in self.items(keep_base=True):
            _raise_if_list_state(m._defaults, f"collection member `{name}`")
        if self._device.type == "cuda" and fast_dispatch_enabled():
            static, dynamic = _split_static_kwargs(batched_kwargs, numeric_static=True)
            if self._dispatcher is None:
                self._dispatcher = self._make_dispatcher()
            layout = self._layout()
            out = self._dispatcher.scan(static, tuple(sorted(static.items())),
                                        tuple(states[name][key] for name, key in layout), batched_args, dynamic)
            new: Dict[str, Dict[str, Any]] = {name: {} for name in self._modules}
            for (name, key), leaf in zip(layout, out):
                new[name][key] = leaf
            return new
        with tracing():
            return _scan_fold(self.pure_update, states, batched_args, batched_kwargs)

    # -------------------------------------------------------- compute groups
    def _merge_compute_groups(self) -> None:
        """Merge groups whose leaders' states are equal, leader by leader as
        the JAX package merges them, on a table of every comparison read
        from the device at once (:meth:`_batched_leader_equality`)."""
        equal = self._batched_leader_equality()
        n_groups = len(self._groups)
        while True:
            for cg_idx1, cg_members1 in deepcopy(self._groups).items():
                for cg_idx2, cg_members2 in deepcopy(self._groups).items():
                    if cg_idx1 == cg_idx2:
                        continue
                    if equal(cg_members1[0], cg_members2[0]):
                        self._groups[cg_idx1].extend(self._groups.pop(cg_idx2))
                        break
                if len(self._groups) != n_groups:
                    break
            if len(self._groups) == n_groups:
                break
            n_groups = len(self._groups)

        self._groups = dict(enumerate(deepcopy(self._groups).values()))

    @staticmethod
    def _state_signature(metric: Metric) -> tuple:
        """The layout of a metric's state, read on the host: names, container
        types and shapes (a list state's length and element shapes). Two
        metrics' states can be equal only if their signatures are; dtype is
        left out, since ``allclose`` compares across dtypes."""
        sig = []
        for key in sorted(metric._defaults):
            state = getattr(metric, key)
            if isinstance(state, list):
                sig.append((key, "list", tuple(tuple(s.shape) for s in state)))
            else:
                sig.append((key, "tensor", tuple(state.shape)))
        return tuple(sig)

    def _batched_leader_equality(self):
        """Every pairwise state equality among the group leaders, as a
        ``(name_a, name_b) -> bool`` lookup.

        Leaders are bucketed by :meth:`_state_signature`; each bucket's
        comparison runs on the device (:func:`_pairwise_equal`) and all the
        buckets' (k, k) tables come to the host in one read. Leaders in
        different buckets are unequal.

        The one difference from the JAX package: a leader with no state of
        its own (``_defaults`` empty, e.g. a ``CompositionalMetric``) equals
        no other. The JAX package counts two such leaders equal and merges
        them: ``MetricCollection({'a': Precision() + Recall(), 'c':
        Precision() * Recall()})`` updated on ``([.2, .8, .6], [0, 1, 1])``
        then ``([.9, .8, .1, .7], [0, 0, 1, 1])`` gives ``c = 1.0`` grouped
        against the right 0.45 ungrouped, since from the second update on
        only ``a``'s operands are updated.
        """
        buckets: Dict[tuple, List[str]] = {}
        for cg in self._groups.values():
            name = cg[0]
            if self._modules[name]._defaults:
                buckets.setdefault(self._state_signature(self._modules[name]), []).append(name)

        tables: List[Tuple[List[str], Tensor]] = []
        for members in buckets.values():
            k = len(members)
            if k < 2:
                continue
            leaf_groups = []
            for key in self._modules[members[0]]._defaults:
                values = [getattr(self._modules[n], key) for n in members]
                if isinstance(values[0], list):
                    # equal lengths and element shapes, by the signature; empty lists add nothing
                    leaf_groups.extend(zip(*values))
                else:
                    leaf_groups.append(tuple(values))
            device = self._modules[members[0]].device
            mat = _pairwise_equal(leaf_groups) if leaf_groups else torch.ones((k, k), dtype=torch.bool, device=device)
            tables.append((members, mat))

        table: Dict[Tuple[str, str], bool] = {}
        if tables:
            flat = torch.cat([mat.reshape(-1).to(tables[0][1].device) for _, mat in tables]).cpu().tolist()  # the one read
            start = 0
            for members, mat in tables:
                k = len(members)
                for i, a in enumerate(members):
                    for j, b in enumerate(members):
                        table[(a, b)] = bool(flat[start + i * k + j])
                start += k * k
        return lambda a, b: table.get((a, b), False)

    @staticmethod
    def _equal_metric_states(metric1: Metric, metric2: Metric) -> bool:
        """Whether two metrics' states are equal (``allclose`` leaf by leaf);
        a metric with no state equals none, as in :meth:`_batched_leader_equality`."""
        if not metric1._defaults or not metric2._defaults:
            return False
        if metric1._defaults.keys() != metric2._defaults.keys():
            return False
        for key in metric1._defaults:
            state1, state2 = getattr(metric1, key), getattr(metric2, key)
            if type(state1) != type(state2):  # noqa: E721
                return False
            if isinstance(state1, Tensor):
                if state1.shape != state2.shape or not _allclose(state1, state2):
                    return False
            elif isinstance(state1, list):
                if len(state1) != len(state2) or not all(
                    s1.shape == s2.shape and _allclose(s1, s2) for s1, s2 in zip(state1, state2)
                ):
                    return False
        return True

    def _compute_groups_create_state_ref(self) -> None:
        """Give every group member its leader's state (the same tensors; a
        list state as a new list of them) and update count.

        A member whose state changes drops its memoised ``compute``. The JAX
        package keeps it, so after update, compute, update, compute a member
        answers its first value again (``Accuracy`` and ``F1Score``, macro,
        C = 3: F1 0.2286 grouped against 0.2401 ungrouped).

        A leader's leaf that an engine writes in place (a graph's state
        buffer) is given as a copy, so that the leader's next replay does not
        change the member's state under it.
        """
        if not (self._enable_compute_groups and self._groups_checked):
            return
        for cg in self._groups.values():
            m0 = self._modules[cg[0]]
            for name in cg[1:]:
                mi = self._modules[name]
                changed = mi._update_count != m0._update_count
                for state in m0._defaults:
                    value, held = getattr(m0, state), getattr(mi, state)
                    if isinstance(value, list):
                        changed |= len(value) != len(held) or any(a is not b for a, b in zip(value, held))
                        value = list(value)
                    elif engine_owned(value):
                        changed = True
                        value = value.clone()
                    else:
                        changed |= value is not held
                    object.__setattr__(mi, state, value)
                mi._update_count = m0._update_count
                if changed:
                    mi._computed = None
                    mi._bump_version()

    @property
    def compute_groups(self) -> Dict[int, List[str]]:
        return self._groups

    # ------------------------------------------------------------- pure API
    def state(self) -> Dict[str, Dict[str, Any]]:
        """``{name: metric.state()}``, group members first given their leader's state."""
        self._compute_groups_create_state_ref()
        return {name: m.state() for name, m in self.items(keep_base=True)}

    def pure_update(self, states: Dict[str, Dict[str, Any]], *args: Any, **kwargs: Any) -> Dict[str, Dict[str, Any]]:
        """The next state of every member (kwargs routed a member)."""
        return {
            name: m.pure_update(states[name], *args, **m._filter_kwargs(**kwargs))
            for name, m in self.items(keep_base=True)
        }

    def pure_merge(
        self,
        states_a: Dict[str, Dict[str, Any]],
        states_b: Dict[str, Dict[str, Any]],
        counts: Any = 2,
    ) -> Dict[str, Dict[str, Any]]:
        """Merge two states member by member; ``counts`` is one count for
        every member or a ``{name: count}`` dict (mean states only)."""
        return {
            name: m.pure_merge(states_a[name], states_b[name], count=counts[name] if isinstance(counts, dict) else counts)
            for name, m in self.items(keep_base=True)
        }

    def pure_compute(self, states: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
        """Every member's value for a state (prefix and postfix applied)."""
        res = _flatten_dict({name: m.pure_compute(states[name]) for name, m in self.items(keep_base=True)})
        return {self._set_name(k): v for k, v in res.items()}

    def load_pure_state(self, states: Dict[str, Dict[str, Any]], increment: bool = False) -> None:
        """Take a state of the pure API into the members; ``increment`` counts
        it as one more update, else the count is held at least 1."""
        for name, m in self.items(keep_base=True):
            m._load_state(states[name])
            m._update_count = m._update_count + 1 if increment else max(m._update_count, 1)
            m._computed = None
            m._forward_cache = None
            m._bump_version()

    # ----------------------------------------------------------- checkpoints
    def clone(self, prefix: Optional[str] = None, postfix: Optional[str] = None) -> "MetricCollection":
        mc = deepcopy(self)
        if prefix:
            mc.prefix = self._check_arg(prefix, "prefix")
        if postfix:
            mc.postfix = self._check_arg(postfix, "postfix")
        return mc

    def persistent(self, mode: bool = True) -> None:
        for m in self._modules.values():
            m.persistent(mode)

    def state_dict(self, prefix: str = "") -> Dict[str, Any]:
        """Every member's ``state_dict`` under ``<member>.``, with one
        checksum pass over the whole payload."""
        self._compute_groups_create_state_ref()
        destination: Dict[str, Any] = {}
        for name, m in self.items(keep_base=True):
            m.state_dict(destination, prefix=f"{prefix}{name}.")
        return attach_checksums(destination)

    def load_state_dict(self, state_dict: Dict[str, Any], prefix: str = "", strict: bool = True) -> None:
        """Verify the payload's checksums once, then load every member."""
        if not prefix:
            verify_checksums(state_dict)
        for name, m in self.items(keep_base=True):
            m.load_state_dict(state_dict, prefix=f"{prefix}{name}.", strict=strict)

    def to(self, device: Union[str, torch.device]) -> "MetricCollection":
        for m in self._modules.values():
            m.to(device)
        self._dispatcher = None  # its programs and buffers are for the old device
        return self

    def set_dtype(self, dst_type: torch.dtype) -> "MetricCollection":
        for m in self._modules.values():
            m.set_dtype(dst_type)
        return self

    def float(self) -> "MetricCollection":
        """No-op, as ``Metric.float``; use :meth:`set_dtype`."""
        return self

    def double(self) -> "MetricCollection":
        """No-op; use :meth:`set_dtype`."""
        return self

    def half(self) -> "MetricCollection":
        """No-op; use :meth:`set_dtype`."""
        return self

    def type(self, dst_type: Any = None) -> "MetricCollection":
        """No-op; use :meth:`set_dtype`."""
        return self

    def memory_snapshot(self, top_n: int = 10) -> Dict[str, Any]:
        """Bytes of state over every member, leaves named ``"<member>/<state>"``
        (the shape of :meth:`Metric.memory_snapshot`)."""
        leaves: List[Dict[str, Any]] = []
        total = 0
        for name, m in self.items(keep_base=True):
            member = m.memory_snapshot(top_n=len(m._defaults))
            total += member["total_bytes"]
            leaves.extend({**leaf, "name": f"{name}/{leaf['name']}"} for leaf in member["leaves"])
        leaves.sort(key=lambda leaf: (-leaf["nbytes"], leaf["name"]))
        return {"total_bytes": total, "leaf_count": len(leaves), "leaves": leaves[: max(0, int(top_n))]}

    # ------------------------------------------------------------------ sync
    @property
    def sync_stats(self) -> Dict[str, int]:
        """The collection's own sync counters: the bucket pass's collectives,
        buckets and bytes. What a member syncs itself (its list and ragged
        states) counts in its own ``sync_stats``."""
        return dict(self._sync_stats)

    @staticmethod
    def _sync_fusable(m: Metric, env: DistEnv) -> bool:
        """Whether ``m`` joins the shared bucket pass: it syncs by the stock
        protocol (no custom gather, no sync of its own, no env of its own
        other than ``env``) and is neither synced nor memoised."""
        return (
            type(m)._sync_dist is Metric._sync_dist
            and type(m).sync is Metric.sync
            and type(m).unsync is Metric.unsync
            and m.dist_sync_fn is None
            and not m._is_synced
            and m._computed is None
            and (m._sync_env is None or m._sync_env is env)
        )

    def sync(self, env: Optional[DistEnv] = None, should_sync: bool = True) -> None:
        """Sync every member across the environment once.

        The fixed-shape states of every compute-group leader share one bucket
        pass (one collective a wire dtype and reduction, for the whole
        collection); each leader then syncs its list and ragged states, and
        the followers take their leader's synced state with no collective.
        Synced members neither sync again nor unsync in their own ``compute``;
        :meth:`unsync` restores them. Does nothing where the env is not
        distributed or with ``METRICS_TPU_FUSED_SYNC=0``: each member then
        syncs itself in its ``compute``.
        """
        if self._synced_members is not None:
            if should_sync:
                raise MetricsUserError("The MetricCollection has already been synced.")
            return
        if env is None:
            env = next((m._sync_env for m in self._modules.values() if m._sync_env is not None), None) or default_env()
        if not should_sync or not env.is_distributed() or not sync_engine.fused_sync_enabled():
            return
        with telemetry.span("sync", "MetricCollection", "collection"):
            self._sync_leaders(env)

    def _sync_leaders(self, env: DistEnv) -> None:
        """:meth:`sync`'s pass: one bucket pass over the group leaders, each
        leader's other states, then the followers."""
        self._compute_groups_create_state_ref()
        use_groups = bool(self._enable_compute_groups and self._groups_checked)
        leaders = [self._modules[cg[0]] for cg in self._groups.values()] if use_groups else list(self._modules.values())
        fused_members = [m for m in leaders if self._sync_fusable(m, env)]

        synced: List[Metric] = []
        try:
            for m in fused_members:
                m._cache = m._copy_state()
            specs: List[Any] = []
            handled: Dict[int, set] = {}
            for i, m in enumerate(fused_members):
                member_specs = sync_engine.plan_metric_leaves(m, {a: getattr(m, a) for a in m._reductions}, tag=i)
                specs.extend(member_specs)
                handled[i] = {spec.key[1] for spec in member_specs}
            results = sync_engine.execute_buckets(env, specs, owner="MetricCollection", stats=self._sync_stats)
            for (i, attr), val in results.items():
                object.__setattr__(fused_members[i], attr, val)
            # each leader's other states (list, ragged, custom reductions) by the per-leaf protocol
            for i, m in enumerate(fused_members):
                m._sync_dist(None, env=env, exclude=tuple(handled[i]))
                m._is_synced = True
                synced.append(m)
        except Exception as err:  # noqa: BLE001 -- every member restored; each then syncs itself in compute
            for m in fused_members:
                if m not in synced and m._cache is not None:
                    m._load_state(m._cache)
                    m._cache = None
            for m in synced:
                m.unsync()
            if not resilience.resilience_enabled():
                raise
            resilience.record_degrade("MetricCollection", "sync", err)
            rank_zero_warn(
                f"fused collection sync failed ({type(err).__name__}: {err}); "
                "members will sync individually inside compute()"
            )
            return

        # followers take their leader's synced state: no collective. Their unsync restores the leader's local
        # state (an engine's buffer as a copy, so that the leader's next replay leaves it as it is)
        if use_groups:
            for cg in self._groups.values():
                m0 = self._modules[cg[0]]
                if m0 not in fused_members:
                    continue
                for name in cg[1:]:
                    mi = self._modules[name]
                    if mi._is_synced or mi._computed is not None:
                        continue
                    mi._cache = {k: list(v) if isinstance(v, list) else (v.clone() if engine_owned(v) else v)
                                 for k, v in m0._cache.items()}
                    for state in m0._defaults:
                        value = getattr(m0, state)
                        object.__setattr__(mi, state, list(value) if isinstance(value, list) else value)
                    mi._update_count = m0._update_count
                    mi._is_synced = True
                    synced.append(mi)

        self._synced_members = []
        for m in synced:
            # a synced member's compute neither syncs again nor unsyncs
            self._synced_members.append((m, m._to_sync, m._should_unsync))
            m._to_sync = False
            m._should_unsync = False

    def unsync(self, should_unsync: bool = True) -> None:
        """Restore every member the last :meth:`sync` touched."""
        if not should_unsync:
            return
        members, self._synced_members = self._synced_members, None
        for m, to_sync, should in members or ():
            m._to_sync = to_sync
            m._should_unsync = should
            if m._is_synced:
                m.unsync()

    @contextmanager
    def sync_context(
        self, env: Optional[DistEnv] = None, should_sync: bool = True, should_unsync: bool = True
    ) -> Generator[None, None, None]:
        """The collection's sync, the block, unsync."""
        self.sync(env=env, should_sync=should_sync)
        try:
            yield
        finally:
            self.unsync(should_unsync=should_unsync)

    def pure_sync(
        self, states: Dict[str, Dict[str, Any]], group: Any = None, env: Optional[DistEnv] = None
    ) -> Dict[str, Dict[str, Any]]:
        """Every member's state synced over ``group`` (the default group where
        None; ``env`` gives the collectives explicitly instead). With the
        bucketed sync on, the fixed-shape states of all members share one
        collective a bucket; list and ragged states sync a member at a time."""
        env = env or group_env(group)
        if not sync_engine.fused_sync_enabled():
            return {name: m.pure_sync(states[name], env=env) for name, m in self.items(keep_base=True)}
        specs: List[Any] = []
        for name, m in self.items(keep_base=True):
            if type(m)._sync_dist is not Metric._sync_dist:
                continue  # a sync of its own stays the member's
            member_states = {k: v for k, v in states[name].items() if k in m._reductions}
            specs.extend(sync_engine.plan_metric_leaves(m, member_states, tag=name))
        fused = sync_engine.execute_buckets(env, specs, owner="MetricCollection", stats=self._sync_stats)
        out: Dict[str, Dict[str, Any]] = {}
        for name, m in self.items(keep_base=True):
            handled = {attr: val for (n, attr), val in fused.items() if n == name}
            if not handled:
                out[name] = m.pure_sync(states[name], env=env)
                continue
            saved = m._copy_state()
            try:
                m._load_state(states[name])
                m._sync_dist(dist_sync_fn=None, env=env, exclude=tuple(handled))
                synced = m._copy_state()
            finally:
                m._load_state(saved)
            synced.update(handled)
            out[name] = synced
        return out

    def telemetry_snapshot(self) -> Dict[str, Any]:
        """The fused path's stats, each member's :meth:`Metric.telemetry_snapshot`
        under ``members``, the state bytes and the ``aot_cache`` block, with the
        JAX package's keys (``metrics_tpu/collections.py:686``)."""
        return {
            "owner": "MetricCollection",
            "dispatch": self.dispatch_stats,
            "sync": dict(self._sync_stats),
            "forward": self.forward_stats,
            "resilience": {
                "fused": self._fuse_resilience.stats(),
                "fuse_failed": self._fuse_failed,
            },
            "aot_cache": aot_cache_stats(),
            "memory": self.memory_snapshot(),
            "members": {name: m.telemetry_snapshot() for name, m in self.items(keep_base=True)},
        }

    # --------------------------------------------------------------- adding
    def add_metrics(
        self, metrics: Union[Metric, Sequence[Metric], Dict[str, Metric]], *additional_metrics: Metric
    ) -> None:
        """Add metrics to the collection."""
        if isinstance(metrics, Metric):
            metrics = [metrics]
        if isinstance(metrics, Sequence):
            metrics = list(metrics)
            remain: list = []
            for m in additional_metrics:
                (metrics if isinstance(m, Metric) else remain).append(m)
            if remain:
                rank_zero_warn(
                    f"You have passed extra arguments {remain} which are not `Metric` so they will be ignored."
                )
        elif additional_metrics:
            raise ValueError(
                f"You have passed extra arguments {additional_metrics} which are not compatible"
                f" with first passed dictionary {metrics} so they will be ignored."
            )

        if isinstance(metrics, dict):
            for name in sorted(metrics.keys()):
                metric = metrics[name]
                if not isinstance(metric, Metric):
                    raise ValueError(f"Value {metric} belonging to key {name} is not an instance of `Metric`")
                self[name] = metric
        elif isinstance(metrics, Sequence):
            for metric in metrics:
                if not isinstance(metric, Metric):
                    raise ValueError(f"Input {metric} to `MetricCollection` is not an instance of `Metric`")
                name = metric.__class__.__name__
                if name in self:
                    raise ValueError(f"Encountered two metrics both named {name}")
                self[name] = metric
        else:
            raise ValueError("Unknown input to MetricCollection.")

        self._groups_checked = False
        if self._enable_compute_groups:
            self._init_compute_groups()
        else:
            self._groups = {}

    def _init_compute_groups(self) -> None:
        """The groups as given (no comparison then), or one a member until the first update."""
        if isinstance(self._enable_compute_groups, list):
            self._groups = dict(enumerate(self._enable_compute_groups))
            for v in self._groups.values():
                for metric in v:
                    if metric not in self:
                        raise ValueError(
                            f"Input {metric} in `compute_groups` argument does not match a metric in the collection."
                        )
            self._groups_checked = True
        else:
            self._groups = {i: [str(k)] for i, k in enumerate(self.keys(keep_base=True))}

    # ---------------------------------------------------------------- naming
    def _set_name(self, base: str) -> str:
        name = base if self.prefix is None else self.prefix + base
        return name if self.postfix is None else name + self.postfix

    def _to_renamed_ordered_dict(self) -> OrderedDict:
        return OrderedDict((self._set_name(k), v) for k, v in self._modules.items())

    def keys(self, keep_base: bool = False) -> Iterable[Hashable]:
        if keep_base:
            return self._modules.keys()
        return self._to_renamed_ordered_dict().keys()

    def items(self, keep_base: bool = False) -> Iterable[Tuple[str, Metric]]:
        if keep_base:
            return self._modules.items()
        return self._to_renamed_ordered_dict().items()

    @staticmethod
    def _check_arg(arg: Optional[str], name: str) -> Optional[str]:
        if arg is None or isinstance(arg, str):
            return arg
        raise ValueError(f"Expected input `{name}` to be a string, but got {type(arg)}")

    def __repr__(self) -> str:
        repr_str = self.__class__.__name__ + "(\n"
        for k, v in self._modules.items():
            repr_str += f"  ({k}): {v!r}\n"
        if self.prefix:
            repr_str += f"  prefix={self.prefix}\n"
        if self.postfix:
            repr_str += f"  postfix={self.postfix}\n"
        return repr_str + ")"
