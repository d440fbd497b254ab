"""Report writer (port of ``repro.lab.report``): the lab's JSON artifact
and the convergence results table, byte for byte the reference's for the
same runs and claims.

The markdown splice follows the marker convention of
``benchmarks/make_report.py``: everything between ``<!-- CONVERGENCE_TABLE -->``
and the next ``## `` section header is regenerated in place.  The port's
CLI writes neither the repo's ``BENCH_*.json`` nor ``docs/EXPERIMENTS.md``
unless a path names them.
"""

from __future__ import annotations

import json
from typing import Dict, List

__all__ = ["write_json", "render_markdown", "splice_experiments_md", "MARKER"]

MARKER = "<!-- CONVERGENCE_TABLE -->"


def write_json(path: str, runs: Dict[str, Dict], claims: List[Dict],
               all_passed: bool) -> None:
    """The JSON artifact: full matrix evidence + claim verdicts."""
    payload = {
        "bench": "convergence_lab",
        "all_claims_passed": bool(all_passed),
        "claims": claims,
        "runs": runs,
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
        f.write("\n")


def _fmt_schedule(spec: Dict) -> str:
    sched = spec.get("schedule")
    if spec.get("reducer") is None:
        return "—"
    if sched is None:
        return "static"
    if sched["kind"] == "constant":
        return f"θ={sched['theta']}"
    if sched["kind"] == "step_decay":
        pts = sched["points"]
        return "→".join(f"{v}" for _, v in pts)
    return sched["kind"]


def _fmt_ratio(run: Dict) -> str:
    recs = [r for r in run["records"] if r.get("compression_ratio")]
    if not recs:
        return "—"
    mean = sum(r["compression_ratio"] for r in recs) / len(recs)
    return f"{mean:.1f}×"


def _fmt_wire(run: Dict) -> str:
    wire = run.get("wire")
    if not wire or not wire.get("compressed_bits"):
        return "—"
    return f"{wire['savings']:.1f}×"


def render_markdown(runs: Dict[str, Dict], claims: List[Dict],
                    all_passed: bool) -> str:
    """The Convergence results block: run table + claim checklist."""
    lines = [
        "| experiment | reducer | transport | backend | θ-schedule | final loss | Δ vs dense | comp. | wire sav. | steps·workers |",
        "|---|---|---|---|---|---:|---:|---:|---:|---|",
    ]
    dense_final = {
        run["spec"]["model"]: run["final_loss"]
        for run in runs.values() if run["spec"]["reducer"] is None
    }
    for name in sorted(runs):
        run = runs[name]
        spec = run["spec"]
        base = dense_final.get(spec["model"])
        delta = ("—" if base is None or spec["reducer"] is None
                 else f"{run['final_loss'] - base:+.4f}")
        lines.append(
            f"| {name} | {spec['reducer'] or 'dense'} | "
            f"{spec['transport'] if spec['reducer'] else '—'} | "
            f"{spec.get('backend', 'reference') if spec['reducer'] else '—'} | "
            f"{_fmt_schedule(spec)} | {run['final_loss']:.4f} | {delta} | "
            f"{_fmt_ratio(run)} | {_fmt_wire(run)} | "
            f"{spec['steps']}·{spec['workers']} |")
    lines.append("")
    lines.append(f"**Claims ({'all pass' if all_passed else 'FAILURES'}):**")
    lines.append("")
    for c in claims:
        mark = "✅" if c["passed"] else "❌"
        lines.append(f"- {mark} `{c['name']}` — {c['detail']}")
    return "\n".join(lines) + "\n"


def splice_experiments_md(exp_path: str, block: str) -> bool:
    """Replace the marker..next-section region of EXPERIMENTS.md in place.

    Returns False (no write) when the marker is absent — callers running
    against a scratch docs tree shouldn't invent structure.
    """
    with open(exp_path) as f:
        text = f.read()
    if MARKER not in text:
        return False
    head, _, tail = text.partition(MARKER)
    nxt = tail.find("\n## ")
    tail2 = tail[nxt:] if nxt != -1 else "\n"
    with open(exp_path, "w") as f:
        f.write(head + MARKER + "\n\n" + block + tail2)
    return True
