#!/usr/bin/env python
"""Offline checkpoint-ladder + journal scrubber of the PyTorch port.

The port's counterpart of ``tools/wal_scrub.py``, on ``metrics_tpu_torch``
alone (the two packages write the same bytes, so either scrubs the other's
directories).

Walks a service's checkpoint directory (the ladder rungs PLUS the live
checkpoint) and its journal directory, and verifies the whole
point-in-time-recovery chain *without* a running service:

* every rung's archive crc (``resilience.verify_checksums``) and
  ``__meta__`` integrity;
* every rung's **replay tail**: the journal's ``first_seq()`` must not
  have truncated past ``fence + 1``, and the tail frames above the fence
  must decode (frame crc, torn-tail detection);
* the journal itself: total retained frames, torn-tail bytes, epoch.

Corrupt rungs are QUARANTINED — renamed ``<rung>.quarantine``, never
deleted (they are evidence for the post-mortem) — with cause-tagged
``degrade:history`` telemetry spans, exactly like the online
:meth:`metrics_tpu_torch.serve.MetricsService.scrub`. ``--dry-run``
reports without renaming.

Usage::

    python tools/torch_wal_scrub.py --checkpoint-dir /state/ckpt --journal-dir /state/wal
    python tools/torch_wal_scrub.py --checkpoint-dir /state/ckpt --journal-dir /state/wal --dry-run
    python tools/torch_wal_scrub.py ... --json          # machine-readable report

Exit status: 0 when every rung verified, 1 when anything was quarantined
(or would have been, under ``--dry-run``), 2 on operator error.
"""
import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402

from metrics_tpu_torch import resilience, telemetry, wal  # noqa: E402
from metrics_tpu_torch.utilities.checksums import CHECKSUM_PREFIX, verify_checksums  # noqa: E402


def _rung_candidates(checkpoint_dir: str) -> List[Tuple[Optional[int], str]]:
    """Every verifiable checkpoint file in the directory: ladder rungs
    (fence parsed from the suffix) ascending, then live ``*.npz``
    checkpoints (fence read from meta). Quarantined files are skipped —
    they are already out of the recovery path."""
    try:
        names = sorted(os.listdir(checkpoint_dir))
    except FileNotFoundError:
        return []
    rungs: List[Tuple[Optional[int], str]] = []
    live: List[Tuple[Optional[int], str]] = []
    for n in names:
        if n.endswith(".quarantine") or n.endswith(".tmp"):
            continue
        full = os.path.join(checkpoint_dir, n)
        if ".rung-" in n:
            try:
                rungs.append((int(n.rsplit(".rung-", 1)[1]), full))
            except ValueError:
                continue
        elif n.endswith(".npz"):
            live.append((None, full))
    rungs.sort(key=lambda fp: fp[0])
    return rungs + live


def _verify_rung(path: str) -> Dict[str, Any]:
    """Load + checksum one checkpoint file; returns its parsed meta.
    Raises ``StateCorruptionError`` on any damage."""
    try:
        with np.load(path) as data:
            payload = {k: data[k] for k in data.files}
    except Exception as err:  # noqa: BLE001 - torn write, not-a-zip, ...
        raise resilience.StateCorruptionError(
            f"checkpoint {path!r} is unreadable: {err}"
        ) from err
    verify_checksums(payload)
    payload = {k: v for k, v in payload.items() if not str(k).startswith(CHECKSUM_PREFIX)}
    try:
        return json.loads(bytes(payload.pop("__meta__")).decode())
    except Exception as err:  # noqa: BLE001 - missing/garbled meta entry
        raise resilience.StateCorruptionError(
            f"checkpoint {path!r} has a missing or garbled __meta__: {err}"
        ) from err


def scrub(
    checkpoint_dir: str,
    journal_dir: Optional[str],
    *,
    quarantine: bool = True,
) -> Dict[str, Any]:
    """The scrub pass as a library call (the CLI below is a thin shell).
    Returns the report dict; mutates the ladder only when ``quarantine``."""
    journal: Optional[wal.WriteAheadLog] = None
    journal_info: Optional[Dict[str, Any]] = None
    if journal_dir is not None and os.path.isdir(journal_dir):
        # read-only posture: open AT the directory's current fence (never
        # bump it — scrub must not fence out the live writer), never append
        journal = wal.WriteAheadLog(
            journal_dir, owner="wal-scrub", epoch=wal.read_epoch(journal_dir)
        )
        journal_info = {
            "first_seq": journal.first_seq(),
            "last_seq": journal.last_seq,
            "retained_records": len(journal.read_tail(0)),
        }
    rungs: List[Dict[str, Any]] = []
    quarantined: List[str] = []
    for fence, path in _rung_candidates(checkpoint_dir):
        entry: Dict[str, Any] = {"path": path, "fence": fence}
        err: Optional[Exception] = None
        try:
            meta = _verify_rung(path)
            meta_fence = int(meta.get("journal_seq", 0))
            entry["fence"] = meta_fence
            if fence is not None and fence != meta_fence:
                raise resilience.StateCorruptionError(
                    f"rung {path!r} names fence {fence} but its meta says {meta_fence}"
                )
            if journal is not None:
                if journal.first_seq() > meta_fence + 1:
                    raise resilience.StateCorruptionError(
                        f"rung {path!r} (fence {meta_fence}) lost its replay "
                        f"tail: journal starts at {journal.first_seq()}"
                    )
                # prove the tail decodes end to end (frame crc + payloads)
                entry["tail_records"] = len(journal.read_tail(meta_fence))
        except resilience.StateCorruptionError as caught:
            err = caught
        if err is None:
            entry["ok"] = True
        else:
            entry["ok"] = False
            entry["error"] = str(err)
            quarantined.append(path)
            telemetry.emit(
                "degrade", "wal-scrub", kind="history",
                cause="scrub-corrupt-rung", rung=os.path.basename(path),
            )
            if quarantine:
                os.replace(path, path + ".quarantine")
        rungs.append(entry)
    verified = [r["fence"] for r in rungs if r["ok"] and r["fence"] is not None]
    return {
        "checkpoint_dir": checkpoint_dir,
        "journal": journal_info,
        "checked": len(rungs),
        "rungs": rungs,
        "quarantined": quarantined,
        "newest_verified": max(verified) if verified else None,
    }


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint-dir", required=True)
    ap.add_argument("--journal-dir", default=None)
    ap.add_argument(
        "--dry-run", action="store_true",
        help="report corrupt rungs without renaming them",
    )
    ap.add_argument("--json", action="store_true", dest="as_json")
    args = ap.parse_args(argv)
    if not os.path.isdir(args.checkpoint_dir):
        print(f"checkpoint dir {args.checkpoint_dir!r} does not exist", file=sys.stderr)
        return 2
    report = scrub(
        args.checkpoint_dir, args.journal_dir, quarantine=not args.dry_run
    )
    if args.as_json:
        print(json.dumps(report, indent=2))
    else:
        print(f"== wal scrub: {args.checkpoint_dir} ==")
        if report["journal"] is not None:
            j = report["journal"]
            print(
                f"  journal: seqs [{j['first_seq']}, {j['last_seq']}] "
                f"({j['retained_records']} retained records)"
            )
        for r in report["rungs"]:
            tag = "ok" if r["ok"] else ("DRY-QUARANTINE" if args.dry_run else "QUARANTINED")
            tail = f" tail={r['tail_records']}" if "tail_records" in r else ""
            print(f"  [{tag}] {os.path.basename(r['path'])} fence={r['fence']}{tail}")
            if not r["ok"]:
                print(f"         {r['error']}")
        print(
            f"  {report['checked']} checked, {len(report['quarantined'])} corrupt, "
            f"newest verified fence: {report['newest_verified']}"
        )
    return 1 if report["quarantined"] else 0


if __name__ == "__main__":
    sys.exit(main())
