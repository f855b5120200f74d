"""Cross-run regression gate: diff two runs' durable artifacts.

::

    python -m repro_torch.obs.compare <current> <baseline> [--thresholds F]
                                      [--report out.json]

Each argument is an artifact file or a directory holding one: a benchmark
summary (``bench_summary.json``) or a run manifest (``run_manifest.json``,
:class:`repro_torch.obs.Telemetry`); the kind is detected from the content
and must match between the two sides.  Metrics are flattened to dotted
paths and judged by per-metric threshold rules (``fnmatch`` patterns),
with an exit code a CI job can gate on:

- ``0``: every matched metric within threshold;
- ``1``: at least one regression (threshold exceeded, or a metric the
  baseline had is missing from the current artifact);
- ``2``: usage or load error (unreadable artifact, mismatched kinds).

Rule kinds: ``rel_increase``/``rel_decrease`` (fractional drift of a
lower-/higher-is-better metric), ``abs_increase``/``abs_decrease``
(absolute drift: counters like divergences), ``bool_regress`` (a flag that
was true must stay true).  A metric new in the current artifact is reported
but never fails.  :data:`DEFAULT_RULES` are the JAX package's; a rules file
is read only when ``--thresholds`` names one.
"""
from __future__ import annotations

import fnmatch
import json
import os
import sys

BENCH_NAMES = ("bench_summary.json",)
MANIFEST_NAMES = ("run_manifest.json",)

DEFAULT_RULES = {
    # benchmark summaries: generous on wall-clock (cross-machine noise),
    # strict on counters and budget flags
    "bench": [
        {"metric": "logreg.ms_per_leapfrog", "kind": "rel_increase",
         "max": 1.0},
        {"metric": "hmm.ms_per_leapfrog", "kind": "rel_increase",
         "max": 1.0},
        {"metric": "logreg.min_ess", "kind": "rel_decrease", "max": 0.6},
        {"metric": "*.divergences", "kind": "abs_increase", "max": 10},
        {"metric": "chees.ess_per_sec_ratio_at_max_chains",
         "kind": "rel_decrease", "max": 0.6},
        {"metric": "obs_overhead.within_budget", "kind": "bool_regress"},
        {"metric": "obs_overhead.monitor_within_budget",
         "kind": "bool_regress"},
    ],
    # run manifests: diagnostics must not drift
    "manifest": [
        {"metric": "divergences", "kind": "abs_increase", "max": 0},
        {"metric": "final.convergence.max_rhat", "kind": "abs_increase",
         "max": 0.05},
        {"metric": "final.convergence.min_ess", "kind": "rel_decrease",
         "max": 0.5},
        {"metric": "final.divergences", "kind": "abs_increase", "max": 0},
    ],
}


def flatten(obj):
    """Dotted-path -> numeric/bool leaves (lists are skipped: rows tables
    are layout, not headline metrics)."""
    out = {}

    def walk(o, prefix):
        if not isinstance(o, dict):
            return
        for k, v in o.items():
            path = f"{prefix}{k}"
            if isinstance(v, dict):
                walk(v, path + ".")
            elif isinstance(v, bool):
                out[path] = v
            elif isinstance(v, (int, float)):
                out[path] = float(v)

    walk(obj, "")
    return out


def load_artifact(path):
    """Load one artifact -> (kind, flat_metrics, raw).  ``path`` may be the
    file itself or a directory holding ``bench_summary.json`` /
    ``run_manifest.json``."""
    if os.path.isdir(path):
        for name in BENCH_NAMES + MANIFEST_NAMES:
            cand = os.path.join(path, name)
            if os.path.exists(cand):
                path = cand
                break
        else:
            raise FileNotFoundError(
                f"{path} contains neither {BENCH_NAMES[0]} nor "
                f"{MANIFEST_NAMES[0]}")
    with open(path) as f:
        raw = json.load(f)
    if not isinstance(raw, dict):
        raise ValueError(f"{path}: not a JSON object")
    if "sessions" in raw:
        flat = flatten({k: v for k, v in raw.items()
                        if k not in ("sessions", "run")})
        flat.update(flatten({"run": raw.get("run", {})}))
        sessions = raw.get("sessions") or []
        if sessions and isinstance(sessions[-1].get("final"), dict):
            flat.update(flatten({"final": sessions[-1]["final"]}))
        return "manifest", flat, raw
    return "bench", flatten(raw), raw


def _judge(rule, base, cur):
    kind = rule["kind"]
    if kind == "bool_regress":
        return bool(base) and not bool(cur)
    limit = float(rule.get("max", 0.0))
    if kind == "rel_increase":
        return cur > base * (1.0 + limit) + 1e-12
    if kind == "rel_decrease":
        return cur < base * (1.0 - limit) - 1e-12
    if kind == "abs_increase":
        return cur > base + limit + 1e-12
    if kind == "abs_decrease":
        return cur < base - limit - 1e-12
    raise ValueError(f"unknown rule kind {kind!r}")


def compare(current_flat, baseline_flat, rules):
    """Apply ``rules`` to the two flattened metric dicts.  Returns the
    report dict (``rows`` + ``ok``); regressions are rows with status
    ``"regression"`` or ``"missing"``."""
    rows = []
    for rule in rules:
        pattern = rule["metric"]
        matched = sorted(k for k in set(baseline_flat) | set(current_flat)
                         if fnmatch.fnmatch(k, pattern))
        for key in matched:
            base = baseline_flat.get(key)
            cur = current_flat.get(key)
            row = {"metric": key, "rule": rule["kind"],
                   "threshold": rule.get("max"),
                   "baseline": base, "current": cur}
            if base is None:
                row["status"] = "new"          # informational, never fails
            elif cur is None:
                row["status"] = "missing"      # baseline had it: regression
            elif _judge(rule, base, cur):
                row["status"] = "regression"
            else:
                row["status"] = "ok"
            rows.append(row)
    regressions = [r for r in rows if r["status"] in ("regression",
                                                      "missing")]
    return {"rows": rows, "num_regressions": len(regressions),
            "ok": not regressions}


def _fmt(v):
    if v is None:
        return "-"
    if isinstance(v, bool):
        return str(v)
    return f"{v:.6g}"


def render(report) -> str:
    lines = [f"{'status':<11} {'metric':<44} {'baseline':>12} "
             f"{'current':>12} {'rule':>14}"]
    for row in report["rows"]:
        rule = row["rule"]
        if row.get("threshold") is not None:
            rule += f"({row['threshold']:g})"
        lines.append(f"{row['status']:<11} {row['metric']:<44} "
                     f"{_fmt(row['baseline']):>12} {_fmt(row['current']):>12} "
                     f"{rule:>14}")
    verdict = ("OK — no regressions" if report["ok"] else
               f"REGRESSION — {report['num_regressions']} metric(s) failed")
    lines.append(verdict)
    return "\n".join(lines)


def run(current_path, baseline_path, thresholds_path=None,
        report_path=None):
    """Library entry point: returns (exit_code, report_or_None)."""
    try:
        cur_kind, cur_flat, _ = load_artifact(current_path)
        base_kind, base_flat, _ = load_artifact(baseline_path)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2, None
    if cur_kind != base_kind:
        print(f"error: artifact kinds differ — current is {cur_kind}, "
              f"baseline is {base_kind}", file=sys.stderr)
        return 2, None
    rules = DEFAULT_RULES[cur_kind]
    if thresholds_path is not None:
        try:
            with open(thresholds_path) as f:
                loaded = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(f"error: cannot read thresholds {thresholds_path}: {e}",
                  file=sys.stderr)
            return 2, None
        rules = loaded.get(cur_kind, rules) if isinstance(loaded, dict) \
            else loaded
    report = compare(cur_flat, base_flat, rules)
    report["kind"] = cur_kind
    report["current"] = str(current_path)
    report["baseline"] = str(baseline_path)
    print(render(report))
    if report_path is not None:
        os.makedirs(os.path.dirname(report_path) or ".", exist_ok=True)
        with open(report_path, "w") as f:
            json.dump(report, f, indent=1)
        print(f"report written to {report_path}")
    return (0 if report["ok"] else 1), report


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    thresholds = report_path = None
    if "--thresholds" in argv:
        i = argv.index("--thresholds")
        thresholds = argv[i + 1]
        del argv[i:i + 2]
    if "--report" in argv:
        i = argv.index("--report")
        report_path = argv[i + 1]
        del argv[i:i + 2]
    if len(argv) != 2:
        print("usage: python -m repro_torch.obs.compare <current> <baseline> "
              "[--thresholds rules.json] [--report out.json]",
              file=sys.stderr)
        return 2
    code, _ = run(argv[0], argv[1], thresholds, report_path)
    return code


if __name__ == "__main__":
    sys.exit(main())
