"""Run every example of the port end to end with asserted posterior checks
(counterpart of examples/run_examples.py, the same 56 examples: seven
``main()`` files and four parametrised families).

Usage: python examples_torch/run_examples.py [--cpu] [--only SUBSTR[,SUBSTR...]]
                                             [--skip SUBSTR[,SUBSTR...]] [--record PATH]
       python examples_torch/run_examples.py --merge A.json B.json ... --record PATH

Every example runs on the card unless ``--cpu`` is given; without ``--cpu``
and without CUDA the run fails at once (it never carries on on the CPU).
``--record`` writes a JSON artifact {platform, device, card, passed, total,
failed, errors, seconds, example_seconds} even when examples fail or
crash: each example runs under a broad ``except Exception`` so that one
crash costs one row, with the traceback tail kept in ``errors``.
The record is rewritten after every example, so a run cut short keeps
what finished.  ``--merge`` joins the records of runs split by ``--only``
into one.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))

MAIN_MODULES = (
    "readme_normal",
    "bivariate_normal_gibbs",
    "poisson_mh",
    "gamma_mh",
    "gamma_mh_truncation",
    "normal_adaptive",
    "rats_gibbs",
)
FAMILIES = (
    ("swiss_matrix", "SWISS_EXAMPLES"),
    ("normal_family", "NORMAL_EXAMPLES"),
    ("bivariate_family", "BIVARIATE_EXAMPLES"),
    ("t_mh", "T_EXAMPLES"),
)


def build_registry():
    """(name -> callable(device=...), import_errors): each callable runs and
    asserts one example.  Imports are isolated per module: an import-time
    crash in one example file lands in import_errors and costs only that
    module's examples."""
    if os.path.dirname(HERE) not in sys.path:
        sys.path.insert(0, os.path.dirname(HERE))
    registry, import_errors = {}, {}
    for name in MAIN_MODULES:
        try:
            registry[name] = importlib.import_module(f"examples_torch.{name}").main
        except Exception:
            import_errors[name] = traceback.format_exc(limit=4)[-800:]
    for mod, attr in FAMILIES:
        try:
            registry.update(getattr(importlib.import_module(f"examples_torch.{mod}"), attr))
        except Exception:
            import_errors[mod] = traceback.format_exc(limit=4)[-800:]
    return registry, import_errors


def card_line():
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out.splitlines()[0] if out else None


def run(names, registry, import_errors, device, record_path=None):
    """Run ``names`` in order; returns the record, written to
    ``record_path`` (if given) after every example."""
    import torch

    on_card = device == "cuda"
    head = {
        "platform": "cuda" if on_card else "cpu",
        "device": torch.cuda.get_device_name() if on_card else "cpu",
        "card": card_line() if on_card else None,
        "torch": torch.__version__,
    }
    failed, errors, seconds = [], {}, {}

    def record():
        out = dict(
            head,
            # failed import modules count as extra (unrunnable) entries
            passed=len(seconds) - len([f for f in failed if f in seconds]),
            total=len(seconds) + len(import_errors),
            failed=list(failed),
            errors=dict(errors),
            seconds=time.perf_counter() - t_suite,
            example_seconds=dict(seconds),
        )
        if record_path:
            with open(record_path, "w") as f:
                json.dump(out, f, indent=1)
        return out

    for mod, tb in import_errors.items():
        failed.append(mod)
        errors[mod] = tb
        print(f"----- {mod}: IMPORT ERROR\n{tb}", flush=True)
    t_suite = time.perf_counter()
    for i, name in enumerate(names, 1):
        print(f"===== [{i}/{len(names)}] {name} =====", flush=True)
        t0 = time.perf_counter()
        try:
            registry[name](device=device)
            print(f"----- {name}: OK {time.perf_counter() - t0:.1f}s", flush=True)
        except AssertionError as e:
            failed.append(name)
            print(f"----- {name}: FAILED {e}", flush=True)
        except Exception:
            failed.append(name)
            errors[name] = traceback.format_exc(limit=8)[-1500:]
            print(f"----- {name}: ERROR\n{errors[name]}", flush=True)
        seconds[name] = time.perf_counter() - t0
        record()
    return record()


def merge(records):
    """One record from the records of runs split by ``--only``."""
    out = {k: records[0][k] for k in ("platform", "device", "card", "torch")}
    for key in ("platform", "device", "card"):
        seen = sorted({str(r[key]) for r in records})
        if len(seen) > 1:
            out[key] = seen
    out.update(passed=sum(r["passed"] for r in records),
               total=sum(r["total"] for r in records),
               failed=[f for r in records for f in r["failed"]],
               errors={k: v for r in records for k, v in r["errors"].items()},
               seconds=sum(r["seconds"] for r in records),
               example_seconds={k: v for r in records
                                for k, v in r["example_seconds"].items()},
               runs=len(records))
    dup = len(out["example_seconds"]) != sum(len(r["example_seconds"]) for r in records)
    if dup:
        raise ValueError("the records run some example more than once")
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="run every example on the CPU")
    ap.add_argument("--only", default=None, help="substring filter, comma-separated")
    ap.add_argument("--skip", default=None,
                    help="leave out the names holding any of these substrings")
    ap.add_argument("--record", default=None, help="write a JSON result artifact here")
    ap.add_argument("--merge", nargs="+", default=None,
                    help="join these records into --record and run nothing")
    args = ap.parse_args()

    if args.merge:
        if not args.record:
            ap.error("--merge needs --record")
        records = []
        for path in args.merge:
            with open(path) as f:
                records.append(json.load(f))
        out = merge(records)
        with open(args.record, "w") as f:
            json.dump(out, f, indent=1)
        print(f"merged {len(records)} records: {out['passed']}/{out['total']} passed")
        sys.exit(1 if out["failed"] else 0)

    import torch

    if not args.cpu and not torch.cuda.is_available():
        print("run_examples: CUDA is not available; pass --cpu to run on the CPU",
              file=sys.stderr)
        sys.exit(2)
    device = "cpu" if args.cpu else "cuda"

    registry, import_errors = build_registry()
    subs = None if args.only is None else [s for s in args.only.split(",") if s]
    skips = [] if args.skip is None else [s for s in args.skip.split(",") if s]
    names = [n for n in registry if (subs is None or any(s in n for s in subs))
             and not any(s in n for s in skips)]
    print(f"{len(names)} examples on {device}", flush=True)
    record = run(names, registry, import_errors, device, args.record)
    if args.record:
        print(f"recorded {args.record}")
    if record["failed"]:
        print(f"FAILED: {record['failed']}")
        sys.exit(1)
    print(f"all {len(names)} examples passed")


if __name__ == "__main__":
    main()
