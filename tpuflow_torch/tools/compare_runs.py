"""Compare two evaluation runs: metric deltas with better/worse signs.

Counterpart of ``tpuflow/tools/compare_runs.py``, with the same table and
JSON. It diffs two ``eval_metrics.json`` files (as either package's
evaluator writes them) and prints a signed table, marking whether each
change is an improvement given the metric's direction (error-like
metrics improve downward, likelihood improves downward in bits/dim).

Usage:
  python -m tpuflow_torch.tools.compare_runs <a/eval_metrics.json> <b/eval_metrics.json> [--json]

The directions table is explicit and conservative: metrics with no
known direction are shown without a verdict rather than guessed.
"""

from __future__ import annotations

import json
import pathlib
import sys

# metric -> "down" (smaller is better) | "up" (larger is better).
_DIRECTION = {
    "test_bpd": "down",
    "test_bpd_last_step": "down",
    "field_rel_l2_mean": "down",
    "tke_rel_l2_mean": "down",
    "vorticity_rel_l2_mean": "down",
    "spectrum_rel_l2": "down",
    "crps_mean": "down",
    "crps_holdout_raw": "down",
    "crps_holdout_recalibrated": "down",
    "skew_mae": "down",
    "kurt_mae": "down",
    "reynolds_uv_rel_l2": "down",
    "pdf_w1_u": "down",
    "pdf_w1_v": "down",
    # divergence_rms_ratio is deliberately direction-less: pred/ref RMS
    # divergence ~1 matches the reference's discretization; smaller can
    # just mean oversmoothing, so no better/worse verdict is assigned.
    "rollout_steps_per_sec": "up",
}
_CONTEXT = ("n_test_traj", "steps", "n_samples", "backend")


def compare(a: dict, b: dict) -> dict:
    """Return {metric: {a, b, delta, verdict}} for shared scalar keys
    plus a context-mismatch list (different ensemble size etc. make
    deltas apples-to-oranges — flagged, not hidden)."""
    rows: dict = {}
    for k in sorted(set(a) & set(b)):
        va, vb = a[k], b[k]
        if not isinstance(va, (int, float)) or not isinstance(vb, (int, float)):
            continue
        if k in _CONTEXT or isinstance(va, bool) or isinstance(vb, bool):
            continue
        delta = vb - va
        verdict = ""
        d = _DIRECTION.get(k)
        if d and abs(delta) > 0:
            better = delta < 0 if d == "down" else delta > 0
            verdict = "better" if better else "worse"
        rows[k] = {"a": va, "b": vb, "delta": delta, "verdict": verdict}
    mismatches = [
        f"{k}: {a.get(k)} vs {b.get(k)}"
        for k in _CONTEXT
        if k in a and k in b and a[k] != b[k]
    ]
    return {"rows": rows, "context_mismatches": mismatches}


def _fmt(result: dict, name_a: str, name_b: str) -> str:
    lines = [f"comparing A={name_a}  ->  B={name_b}"]
    for m in result["context_mismatches"]:
        lines.append(f"  CONTEXT MISMATCH: {m}")
    w = max((len(k) for k in result["rows"]), default=10)
    for k, r in result["rows"].items():
        mark = {"better": "+", "worse": "-", "": " "}[r["verdict"]]
        lines.append(
            f"  {mark} {k:<{w}}  {r['a']:>12.6g} -> {r['b']:>12.6g}"
            f"  ({r['delta']:+.4g}{'  ' + r['verdict'] if r['verdict'] else ''})"
        )
    n_b = sum(1 for r in result["rows"].values() if r["verdict"] == "better")
    n_w = sum(1 for r in result["rows"].values() if r["verdict"] == "worse")
    lines.append(f"  {n_b} better, {n_w} worse "
                 f"({len(result['rows'])} comparable metrics)")
    return "\n".join(lines)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    as_json, paths = False, []
    for a in argv:
        if a == "--json":
            as_json = True
        elif a.startswith("--"):
            raise SystemExit(f"unknown flag {a}")
        else:
            paths.append(a)
    if len(paths) != 2:
        print(__doc__)
        return 2
    pa, pb = (pathlib.Path(p) for p in paths)
    result = compare(json.loads(pa.read_text()), json.loads(pb.read_text()))
    try:
        print(json.dumps(result) if as_json else _fmt(result, str(pa), str(pb)))
    except BrokenPipeError:  # piped into head/less that exited early
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
