"""Dollar attribution: $/hr rates over the roofline model of the cost model.

Port of ``metrics_tpu/analysis/billing.py``. The cost model
(:mod:`metrics_tpu_torch.analysis.cost_model`) knows the model flops and
bytes of each program and kernel launch; this module turns them into money:

* :data:`DEVICE_RATES` maps device-name substrings to a nominal on-demand
  $/hr rate, keyed like ``DEVICE_PEAKS``, with a ``cpu`` host row so the
  accounting stays structural on hosts without a card.
* :func:`modeled_device_seconds` is the roofline occupancy of one launch:
  ``max(flops / peak_flops, bytes / peak_bandwidth)``.
* :func:`cost_microusd` quantises that to **integer microdollars**; a launch
  that did modelled work never rounds to free (the ``max(1, ...)`` floor).
* :func:`apportion` splits one launch's microdollars across the requests of
  a coalesced launch by row count, largest remainder first, so the shares
  sum to the launch's cost exactly.

Rates are nominal list prices, a stable denominator for comparisons, not a
quote. Only the serving stack's spans carry dollars
(:mod:`metrics_tpu_torch.serve`: each stacked launch's cost, apportioned over
its requests).
``METRICS_TPU_BILLING=0`` turns every dollar attribute off.
"""
import os
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import cost_model

__all__ = [
    "DEVICE_RATES",
    "CPU_HOST_PEAKS",
    "billing_enabled",
    "device_rate",
    "modeled_device_seconds",
    "cost_microusd",
    "apportion",
    "usd",
    "launch_cost_attrs",
    "rate_snapshot",
    "reset",
]

# device_kind / platform substring -> nominal on-demand $/hr. Keyed like
# DEVICE_PEAKS (longest-substring-first against device_kind, then the
# platform string as a fallback, then the "cpu" host row). Values are
# published list-price ballparks — a stable denominator, not a quote.
DEVICE_RATES: Dict[str, float] = {
    "H100": 6.98,
    "cuda": 4.00,
    # the host itself costs money; pricing it keeps every dollar pin structural (non-zero) on hosts with no card
    "cpu": 0.20,
}

# Nominal host-CPU peaks (GFLOP/s, GB/s) used for modeled seconds when
# cost_model.device_peaks() has no absolute entry (the relative basis).
# Same spirit as NOMINAL_RIDGE: a fixed denominator so the same program
# models the same seconds on every host.
CPU_HOST_PEAKS: Tuple[float, float] = (200.0, 50.0)

MICRO_PER_USD = 1_000_000


def billing_enabled() -> bool:
    """Kill switch: ``METRICS_TPU_BILLING=0`` disables all dollar attrs."""
    return os.environ.get("METRICS_TPU_BILLING", "1") != "0"


_lock = threading.Lock()
_rate_cache: Optional[Tuple[str, float]] = None


def device_rate(refresh: bool = False) -> Tuple[str, float]:
    """``(rate_key, usd_per_hour)`` for the current card.

    Resolution mirrors :func:`cost_model.device_peaks`: the longest key of
    :data:`DEVICE_RATES` that ``torch.cuda.get_device_name()`` contains,
    else the ``cuda`` row for a card no row names, else the ``cpu`` host
    row: the table always resolves. Probed once, then cached."""
    global _rate_cache
    with _lock:
        if _rate_cache is not None and not refresh:
            return _rate_cache
    key, rate = "cpu", DEVICE_RATES["cpu"]
    try:
        import torch

        if torch.cuda.is_available():
            kind = torch.cuda.get_device_name().lower()
            best = ""
            for sub, r in DEVICE_RATES.items():
                if sub.lower() in kind and len(sub) > len(best):
                    best, rate = sub, r
            key = best or "cuda"
            if not best:
                rate = DEVICE_RATES["cuda"]
    except Exception:  # noqa: BLE001 -- an unreadable card is priced as the host
        key, rate = "cpu", DEVICE_RATES["cpu"]
    with _lock:
        _rate_cache = (key, rate)
    return key, rate


def reset() -> None:
    """Drop the cached rate probe (tests that monkeypatch the table)."""
    global _rate_cache
    with _lock:
        _rate_cache = None


def modeled_device_seconds(entry: Optional[cost_model.CostEntry]) -> float:
    """Roofline occupancy for one launch of ``entry``'s executable.

    ``max(flops / peak_flops, bytes / peak_bandwidth)`` — the binding
    wall is how long the chip is busy. Uses the absolute device peaks
    when the attached device has them, else :data:`CPU_HOST_PEAKS`."""
    if entry is None:
        return 0.0
    peaks = cost_model.device_peaks() or CPU_HOST_PEAKS
    peak_gflops, peak_gbps = peaks
    compute_s = entry.flops / (peak_gflops * 1e9) if peak_gflops > 0 else 0.0
    memory_s = entry.bytes_accessed / (peak_gbps * 1e9) if peak_gbps > 0 else 0.0
    return max(compute_s, memory_s)


def cost_microusd(entry: Optional[cost_model.CostEntry]) -> int:
    """Integer microdollars for one launch of ``entry``'s executable.

    Zero only for a launch that modeled zero work; any nonzero modeled
    occupancy floors at 1 microdollar so quantization never makes a real
    launch free (which would turn the CPU-scale conservation pins into
    vacuous ``0 == 0`` checks)."""
    seconds = modeled_device_seconds(entry)
    if seconds <= 0.0:
        return 0
    _, rate = device_rate()
    micro = seconds * rate / 3600.0 * MICRO_PER_USD
    return max(1, int(round(micro)))


def apportion(total_microusd: int, weights: Sequence[int]) -> List[int]:
    """Split ``total_microusd`` across ``weights`` by largest remainder.

    Shares are proportional to the (masked-row-count) weights, every
    share is a non-negative int, and the shares sum to ``total_microusd``
    **exactly** — the conservation invariant the acceptance test pins.
    All-zero weights split evenly; remainder ties break to the lowest
    index, so the split is deterministic."""
    n = len(weights)
    if n == 0:
        return []
    total = int(total_microusd)
    w = [max(0, int(x)) for x in weights]
    wsum = sum(w)
    if wsum <= 0:
        w = [1] * n
        wsum = n
    shares = []
    remainders = []
    floor_sum = 0
    for i, wi in enumerate(w):
        exact = total * wi
        q, r = divmod(exact, wsum)
        shares.append(q)
        remainders.append((-r, i))
        floor_sum += q
    leftover = total - floor_sum
    for _, i in sorted(remainders):
        if leftover <= 0:
            break
        shares[i] += 1
        leftover -= 1
    return shares


def usd(microusd: int) -> float:
    """Render integer microdollars as float dollars (render time ONLY)."""
    return round(int(microusd) / MICRO_PER_USD, 6)


def launch_cost_attrs(entry: Optional[cost_model.CostEntry]) -> Dict[str, Any]:
    """Dollar attrs for one launch span: modeled seconds + cost.

    Empty when billing is killed or the entry is unknown — the launch
    span then carries exactly its pre-billing attributes."""
    if entry is None or not billing_enabled():
        return {}
    micro = cost_microusd(entry)
    return {
        "modeled_device_s": round(modeled_device_seconds(entry), 9),
        "cost_microusd": micro,
        "cost_usd": usd(micro),
    }


def rate_snapshot() -> Dict[str, Any]:
    """The resolved rate, for health()/fleet views and trace headers."""
    key, rate = device_rate()
    return {"rate_key": key, "usd_per_hour": rate, "enabled": billing_enabled()}
