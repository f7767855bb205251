"""Validate exported Chrome traces (port of ``repro.obs.check``).

    PYTHONPATH=src python -m repro_torch.obs.check trace.json \
        --require train.steps --require-span train.step

Checks, per file:
  * the JSON parses and has a ``traceEvents`` list;
  * every event carries the Chrome trace-event schema fields
    (``ph``/``ts``/``pid``/``tid`` and, for B/E/i/M, ``name``);
  * begin/end events are balanced AND well-nested per (pid, tid) track
    (an "E" must close the innermost open "B" with the same name — the
    contract chrome://tracing and Perfetto assume);
  * timestamps are non-negative and non-decreasing within each span;
  * each ``--require NAME`` metric is present in the embedded ``metrics``
    snapshot (and, for plain numbers, > 0 unless --allow-zero);
  * each ``--require-span NAME`` span opens at least once (the port's
    addition: a run that recorded no ``train.step`` fails).

Exit code 0 when every file passes; 1 with a per-file error report
otherwise.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List


def check_trace(path: str, require: List[str] = (),
                allow_zero: bool = False,
                require_spans: List[str] = ()) -> List[str]:
    """Return a list of problems (empty == valid)."""
    errs: List[str] = []
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        return [f"unreadable: {e}"]
    if isinstance(doc, list):          # bare-array variant is legal Chrome
        events, metrics = doc, {}
    elif isinstance(doc, dict):
        events = doc.get("traceEvents")
        metrics = doc.get("metrics", {})
        if not isinstance(events, list):
            return ["no traceEvents list"]
    else:
        return [f"top level must be object or array, got {type(doc)}"]

    stacks = {}                        # (pid, tid) -> [open B names]
    n_b = n_e = 0
    opened = set()
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errs.append(f"event[{i}] not an object")
            continue
        for field in ("ph", "ts", "pid", "tid"):
            if field not in ev:
                errs.append(f"event[{i}] missing {field!r}")
        ph = ev.get("ph")
        if ph in ("B", "E", "i", "I", "M", "X") and "name" not in ev:
            errs.append(f"event[{i}] ph={ph!r} missing 'name'")
        ts = ev.get("ts")
        if isinstance(ts, (int, float)) and ts < 0:
            errs.append(f"event[{i}] negative ts {ts}")
        key = (ev.get("pid"), ev.get("tid"))
        if ph == "B":
            n_b += 1
            opened.add(ev.get("name"))
            stacks.setdefault(key, []).append((ev.get("name"), ts))
        elif ph == "E":
            n_e += 1
            stack = stacks.get(key)
            if not stack:
                errs.append(f"event[{i}] 'E' {ev.get('name')!r} on track "
                            f"{key} with no open span")
                continue
            name, t0 = stack.pop()
            if ev.get("name") != name:
                errs.append(f"event[{i}] 'E' {ev.get('name')!r} does not "
                            f"close innermost 'B' {name!r} on track {key}")
            if (isinstance(ts, (int, float))
                    and isinstance(t0, (int, float)) and ts < t0):
                errs.append(f"event[{i}] span {name!r} ends ({ts}) before "
                            f"it starts ({t0})")
    for key, stack in stacks.items():
        if stack:
            errs.append(f"track {key}: {len(stack)} unclosed span(s): "
                        f"{[n for n, _ in stack]}")
    if n_b != n_e:
        errs.append(f"unbalanced: {n_b} 'B' events vs {n_e} 'E' events")

    for name in require_spans:
        if name not in opened:
            errs.append(f"required span {name!r} never opens")
    for name in require:
        if name not in metrics:
            errs.append(f"required metric {name!r} missing from snapshot "
                        f"(have {len(metrics)} metrics)")
        elif (not allow_zero and isinstance(metrics[name], (int, float))
                and metrics[name] <= 0):
            errs.append(f"required metric {name!r} is {metrics[name]} "
                        f"(expected > 0)")
    return errs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("traces", nargs="+", help="Chrome trace JSON files")
    ap.add_argument("--require", action="append", default=[],
                    metavar="METRIC",
                    help="metric that must be present (and > 0) in the "
                         "embedded snapshot; repeatable")
    ap.add_argument("--allow-zero", action="store_true",
                    help="required metrics may be 0")
    ap.add_argument("--require-span", action="append", default=[],
                    metavar="SPAN",
                    help="span that must open at least once; repeatable")
    args = ap.parse_args(argv)
    bad = 0
    for path in args.traces:
        errs = check_trace(path, args.require, args.allow_zero,
                           args.require_span)
        if errs:
            bad += 1
            print(f"FAIL {path}")
            for e in errs[:20]:
                print(f"  - {e}")
            if len(errs) > 20:
                print(f"  ... and {len(errs) - 20} more")
        else:
            with open(path) as f:
                doc = json.load(f)
            n = len(doc["traceEvents"] if isinstance(doc, dict) else doc)
            print(f"OK   {path} ({n} events)")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
