"""Sum a device trace by kernel name (port of scripts/trace_agg.py).

    python -m splice_tpu_torch.tools.trace_agg TRACE_DIR [n_steps]

Reads the newest *.json or *.json.gz under TRACE_DIR (a torch.profiler
Chrome trace: utils.profiling, tools/profile_step.py, train_pair's
profile_dir), keeps the device's events (kernels, copies and memsets; on
a CPU run's trace, its operators), takes each event's exclusive time (its
duration less that of events nested inside it on its thread, as the
reference does for XLA's container ops; kernels do not nest), and prints
the total and the top names: ms per step over n_steps (default 1), calls
per step and share of the total.
"""
from __future__ import annotations

import collections
import gzip
import json
import pathlib
import sys
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 44


def load_trace(root: str) -> dict:
    paths = sorted((p for pat in ("*.json", "*.json.gz")
                    for p in pathlib.Path(root).rglob(pat)),
                   key=lambda p: p.stat().st_mtime)
    if not paths:
        raise SystemExit(f"no trace (*.json, *.json.gz) under {root}")
    opener = gzip.open if paths[-1].suffix == ".gz" else open
    with opener(paths[-1], "rt") as f:
        return json.load(f)


def device_events(trace: dict) -> List[dict]:
    """The trace's complete events of the device: CUDA kernels, copies and
    memsets, or, where there is none (a CPU run), the CPU operators."""
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    return dev or [e for e in events if e.get("cat") == "cpu_op"]


def exclusive_times(events: List[dict]) -> None:
    """Each event's self time in e["self"]: its duration less its nested
    children's on the same (pid, tid)."""
    by_tid = collections.defaultdict(list)
    for e in events:
        by_tid[(e.get("pid"), e.get("tid"))].append(e)
    for group in by_tid.values():
        group.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack: List[Tuple[float, dict]] = []
        for e in group:
            e["self"] = e["dur"]
            while stack and stack[-1][0] <= e["ts"]:
                stack.pop()
            if stack:
                stack[-1][1]["self"] -= e["dur"]
            stack.append((e["ts"] + e["dur"], e))


def aggregate(events: List[dict], n_steps: int = 1
              ) -> Tuple[float, List[Dict[str, float]]]:
    """(total ms per step, rows by name: name, calls per step, ms per step,
    share), the largest first."""
    exclusive_times(events)
    ms: Dict[str, float] = collections.Counter()
    calls: Dict[str, int] = collections.Counter()
    for e in events:
        ms[e["name"]] += e["self"] / 1e3
        calls[e["name"]] += 1
    total = sum(ms.values())
    rows = [{"name": n, "calls": calls[n] / n_steps, "ms": t / n_steps,
             "share": t / total if total else 0.0}
            for n, t in sorted(ms.items(), key=lambda kv: -kv[1])]
    return total / n_steps, rows


def main(argv=None) -> None:
    args = list(sys.argv[1:] if argv is None else argv)
    n_steps = int(args[1]) if len(args) > 1 else 1
    total, rows = aggregate(device_events(load_trace(args[0])), n_steps)
    print(f"total device self time: {total:.3f} ms/step ({n_steps} steps, "
          f"{sum(r['calls'] for r in rows):.1f} events/step)")
    print("    ms/step  calls/step  share  name")
    for r in rows[:TOP]:
        print(f"  {r['ms']:9.3f}  {r['calls']:10.1f}  {100 * r['share']:5.1f}%"
              f"  {r['name'][:100]}")


if __name__ == "__main__":
    main()
