"""Evaluator: the paper's accuracy claims as executable checks (port of
``repro.lab.evaluate``, every tolerance unchanged).

Consumes the JSON form of lab runs (``RunResult.to_dict()``) so the same code
evaluates a live matrix and a loaded artifact (the reference's
``BENCH_convergence.json`` too, once its ``_pallas`` rows are named
``_cuda``).  Claims per model family (paper sections in brackets):

* ``theta0.7_matches_dense`` — static theta <= 0.7 reaches a final loss within
  ``loss_tol`` (5%) of the dense baseline [Fig. 11, Thm 3.4].
* ``theta0.9_degrades`` — static theta = 0.9 lands measurably above the
  theta = 0.7 run [Fig. 11's degradation, Thm 3.4's theta^2 noise ball].
* ``mixed_recovers`` — the "mixed comp" schedule (high theta early, 0 late)
  recovers to within ``loss_tol`` of dense [§IV-A1, Thm 3.5].
* ``transports_identical`` — runs differing ONLY in transport trace identical
  loss curves to ``transport_atol`` (they compute the same mean; DESIGN.md §9).
* ``backends_identical`` — runs differing ONLY in engine backend (plain
  ops vs the hand-written CUDA kernels, the ``_cuda`` row) trace identical
  loss curves to
  ``backend_atol`` (codes are bitwise-equal across backends and the exchange
  path shares the spectral decompress, DESIGN.md §13 — backend choice is a
  pure execution-engine knob, never a numerics knob).
* ``streamed_identical`` — runs differing ONLY in exchange dispatch schedule
  (stacked single collective vs backprop-interleaved readiness streaming,
  DESIGN.md §15) trace BITWISE-identical loss curves (atol 0 on CPU: the
  schedule reorders dispatch, never arithmetic).
* ``hierarchical_matches_flat`` — the two-level-topology rows (DESIGN.md
  §18: hierarchical re-compresses once per island — a second, island-shared
  lossy step — and reduce_scatter shards the psum over the bucket axis)
  reach final losses within ``loss_tol`` of the flat psum row.  Convergence
  equivalence, not bitwise: the node-level re-compression is lossy by
  design.
* ``sampled_selector_matches_sort`` — runs differing ONLY in top-k selector
  (exact sort vs O(n) sampled threshold, DESIGN.md §16) reach final losses
  within ``loss_tol`` of each other: the selector perturbs the kept set by a
  few near-tau coefficients, so the claim is convergence-equivalence under
  the same tolerance the theta<=0.7 compression claim uses, not bitwise.
* ``assumption31`` — every probed step's live-gradient reconstruction obeys
  ``err <= 1.05*sqrt(theta) + quant_margin`` (the provable sqrt(theta) energy
  bound of DESIGN.md §6 plus the range-quantizer's relative-error envelope),
  checked through ``assumption31_holds_stats``.
* ``thm34_envelope`` — the measured min-so-far gradient energy stays under the
  Thm 3.4 bound evaluated with plug-in constants estimated from the same
  curve (``core.theory.estimate_curve_constants``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from repro_torch.core.theory import (
    assumption31_holds_stats,
    curves_close,
    estimate_curve_constants,
    thm34_envelope,
)

__all__ = ["Claim", "Tolerances", "evaluate_results", "chaos_claims"]


@dataclasses.dataclass
class Claim:
    name: str
    passed: bool
    detail: str

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Tolerances:
    loss_tol: float = 0.05  # "within 5% of dense"
    degrade_margin: float = 0.01  # theta=0.9 must sit >=1% above theta=0.7
    transport_atol: float = 1e-5  # pointwise curve divergence across transports
    backend_atol: float = 1e-4  # pointwise curve divergence across engine backends
    schedule_atol: float = 0.0  # streamed vs stacked dispatch: bitwise (CPU and card)
    a31_sqrt_slack: float = 1.05  # on the provable sqrt(theta) energy bound
    a31_quant_margin: float = 0.15  # additive headroom for the 8-bit quantizer
    a31_norm_tol: float = 0.08  # ||v_hat||/||v|| headroom under quantization
    thm34_slack: float = 1.0
    final_tail: int = 5  # final loss = mean of the last N recorded steps


def _final(run: Dict, tail: int) -> float:
    curve = [r["loss"] for r in run["records"]]
    tail = min(tail, len(curve))
    return sum(curve[-tail:]) / tail


def _loss_curve(run: Dict) -> List[float]:
    return [r["loss"] for r in run["records"]]


def _models(runs: Dict[str, Dict]) -> List[str]:
    return sorted({r["spec"]["model"] for r in runs.values()})


def _named(runs: Dict[str, Dict], name: str) -> Optional[Dict]:
    return runs.get(name)


def _rel_gap(x: float, base: float) -> float:
    return (x - base) / max(abs(base), 1e-9)


def chaos_claims(
    runs: Dict[str, Dict], tol: Tolerances = Tolerances()
) -> List[Claim]:
    """The resilience claims (DESIGN.md §19), emitted ONLY for models whose
    chaos rows are present — a matrix without fault rows gets no chaos
    claims (so fabricated evaluator fixtures and pre-chaos artifacts keep
    evaluating cleanly)."""
    claims: List[Claim] = []

    def claim(name: str, passed: bool, detail: str) -> None:
        claims.append(Claim(name, bool(passed), detail))

    for m in _models(runs):
        has_chaos = any(f"{m}_chaos_{k}" in runs
                        for k in ("nan", "crash", "corrupt"))
        if not has_chaos:
            continue
        clean = _named(runs, f"{m}_fft_theta0.7")

        # -- nan_step_skipped_matches_clean --------------------------------
        nan_run = _named(runs, f"{m}_chaos_nan")
        if nan_run and clean:
            health = nan_run.get("health") or {}
            nan_steps = sorted({ev["step"]
                                for ev in (nan_run["spec"].get("faults") or [])
                                if ev.get("kind") == "nan_grad"})
            skip_steps = health.get("skip_steps", [])
            exact = skip_steps == nan_steps
            cl, ch = _loss_curve(clean), _loss_curve(nan_run)
            first = nan_steps[0] if nan_steps else len(ch)
            prefix_bitwise = cl[:first] == ch[:first] and first > 0
            fc, fn = _final(clean, tol.final_tail), _final(nan_run, tol.final_tail)
            gap = _rel_gap(fn, fc)
            claim(f"{m}:nan_step_skipped_matches_clean",
                  exact and prefix_bitwise and gap <= tol.loss_tol,
                  f"guard skipped steps {skip_steps} (planned {nan_steps}); "
                  f"pre-fault curve bitwise equal: {prefix_bitwise}; final "
                  f"clean {fc:.4f} vs chaos {fn:.4f} (gap {gap:+.2%}, "
                  f"tol {tol.loss_tol:.0%})")
        elif nan_run:
            claim(f"{m}:nan_step_skipped_matches_clean", False,
                  "missing clean theta0.7 comparator run")

        # -- crash_resume_bitwise ------------------------------------------
        crash_run = _named(runs, f"{m}_chaos_crash")
        if crash_run and clean:
            health = crash_run.get("health") or {}
            resumes = health.get("resumes", 0)
            cl, ch = _loss_curve(clean), _loss_curve(crash_run)
            bitwise = cl == ch and len(ch) > 0
            claim(f"{m}:crash_resume_bitwise",
                  resumes >= 1 and bitwise,
                  f"{resumes} auto-resume(s); kill+resume trajectory bitwise "
                  f"equal to the uninterrupted run: {bitwise} "
                  f"({len(ch)} vs {len(cl)} steps)")
        elif crash_run:
            claim(f"{m}:crash_resume_bitwise", False,
                  "missing clean theta0.7 comparator run")

        # -- corrupt_payload_detected_and_degraded -------------------------
        corrupt_run = _named(runs, f"{m}_chaos_corrupt")
        if corrupt_run:
            health = corrupt_run.get("health") or {}
            spec = corrupt_run["spec"]
            corrupt_steps = sorted({ev["step"]
                                    for ev in (spec.get("faults") or [])
                                    if ev.get("kind") == "payload_corrupt"})
            skip_steps = health.get("skip_steps", [])
            detected = (len(skip_steps) > 0
                        and set(skip_steps) <= set(corrupt_steps))
            transitions = health.get("transitions", [])
            completed = (len(corrupt_run["records"]) == spec["steps"]
                         and math.isfinite(_final(corrupt_run, tol.final_tail)))
            claim(f"{m}:corrupt_payload_detected_and_degraded",
                  detected and len(transitions) > 0 and completed,
                  f"validation caught {len(skip_steps)} corrupted step(s) "
                  f"{skip_steps} of planned {corrupt_steps}; ladder "
                  f"transitions {[t['rung'] for t in transitions]}; run "
                  f"completed: {completed}")
    return claims


def evaluate_results(
    runs: Dict[str, Dict], tol: Tolerances = Tolerances()
) -> Tuple[List[Claim], bool]:
    """Evaluate every claim against a {name: RunResult.to_dict()} matrix."""
    claims: List[Claim] = []

    def claim(name: str, passed: bool, detail: str) -> None:
        claims.append(Claim(name, bool(passed), detail))

    for m in _models(runs):
        dense = _named(runs, f"{m}_dense")
        t07 = _named(runs, f"{m}_fft_theta0.7")
        t09 = _named(runs, f"{m}_fft_theta0.9")
        mixed = _named(runs, f"{m}_fft_mixed")

        if dense and t07:
            fd, f7 = _final(dense, tol.final_tail), _final(t07, tol.final_tail)
            gap = _rel_gap(f7, fd)
            claim(f"{m}:theta0.7_matches_dense", gap <= tol.loss_tol,
                  f"final dense {fd:.4f} vs theta0.7 {f7:.4f} (gap {gap:+.2%}, "
                  f"tol {tol.loss_tol:.0%})")
        else:
            claim(f"{m}:theta0.7_matches_dense", False, "missing dense/theta0.7 run")

        if t07 and t09:
            f7, f9 = _final(t07, tol.final_tail), _final(t09, tol.final_tail)
            gap = _rel_gap(f9, f7)
            claim(f"{m}:theta0.9_degrades", gap >= tol.degrade_margin,
                  f"final theta0.9 {f9:.4f} vs theta0.7 {f7:.4f} (gap {gap:+.2%}, "
                  f"needs >= {tol.degrade_margin:+.0%})")
        else:
            claim(f"{m}:theta0.9_degrades", False, "missing theta0.9/theta0.7 run")

        if dense and mixed:
            fd, fm = _final(dense, tol.final_tail), _final(mixed, tol.final_tail)
            gap = _rel_gap(fm, fd)
            claim(f"{m}:mixed_recovers", gap <= tol.loss_tol,
                  f"final dense {fd:.4f} vs mixed {fm:.4f} (gap {gap:+.2%}, "
                  f"tol {tol.loss_tol:.0%})")
        else:
            claim(f"{m}:mixed_recovers", False, "missing dense/mixed run")

        trio = [t07] + [
            _named(runs, f"{m}_fft_theta0.7_{t}") for t in ("sequenced", "psum")
        ]
        if all(trio):
            worst = 0.0
            ok = True
            base_curve = _loss_curve(trio[0])
            for other in trio[1:]:
                close, div = curves_close(
                    base_curve, _loss_curve(other), tol.transport_atol)
                ok &= close
                worst = max(worst, div)
            claim(f"{m}:transports_identical", ok,
                  f"max pointwise loss divergence across "
                  f"allgather/sequenced/psum: {worst:.2e} (atol {tol.transport_atol})")
        else:
            claim(f"{m}:transports_identical", False, "missing transport trio")

        # topology axis (DESIGN.md §18): two-level transports vs flat psum.
        # One-sided like the dense claim — landing BELOW the flat row is fine.
        psum_run = _named(runs, f"{m}_fft_theta0.7_psum")
        hier = _named(runs, f"{m}_fft_theta0.7_hier")
        rs = _named(runs, f"{m}_fft_theta0.7_rs")
        if psum_run and hier and rs:
            fp = _final(psum_run, tol.final_tail)
            fh = _final(hier, tol.final_tail)
            fr = _final(rs, tol.final_tail)
            gap_h, gap_r = _rel_gap(fh, fp), _rel_gap(fr, fp)
            claim(f"{m}:hierarchical_matches_flat",
                  gap_h <= tol.loss_tol and gap_r <= tol.loss_tol,
                  f"final flat psum {fp:.4f} vs hierarchical {fh:.4f} "
                  f"(gap {gap_h:+.2%}) / reduce_scatter {fr:.4f} "
                  f"(gap {gap_r:+.2%}); tol {tol.loss_tol:.0%}")
        else:
            claim(f"{m}:hierarchical_matches_flat", False,
                  "missing psum/hier/rs topology rows")

        cuda = _named(runs, f"{m}_fft_theta0.7_cuda")
        if t07 and cuda:
            close, div = curves_close(
                _loss_curve(t07), _loss_curve(cuda), tol.backend_atol)
            claim(f"{m}:backends_identical", close,
                  f"max pointwise loss divergence reference vs cuda "
                  f"backend: {div:.2e} (atol {tol.backend_atol})")
        else:
            claim(f"{m}:backends_identical", False, "missing cuda-backend run")

        # selection engine (DESIGN.md §16): the sampled selector changes the
        # kept SET (a few near-tau coefficients), not the payload shape, so
        # the contract is convergence within the theta<=0.7 loss tolerance —
        # the same envelope the compression itself gets — not bitwise curves.
        sampled = _named(runs, f"{m}_fft_theta0.7_sampled")
        if t07 and sampled:
            f7 = _final(t07, tol.final_tail)
            fs = _final(sampled, tol.final_tail)
            gap = _rel_gap(fs, f7)
            claim(f"{m}:sampled_selector_matches_sort", gap <= tol.loss_tol,
                  f"final sort-selector {f7:.4f} vs sampled {fs:.4f} "
                  f"(gap {gap:+.2%}, tol {tol.loss_tol:.0%})")
        else:
            claim(f"{m}:sampled_selector_matches_sort", False,
                  "missing sampled-selector run")

        b_stacked = _named(runs, f"{m}_fft_theta0.7_bucketed_stacked")
        b_streamed = _named(runs, f"{m}_fft_theta0.7_bucketed_streamed")
        if b_stacked and b_streamed:
            close, div = curves_close(
                _loss_curve(b_stacked), _loss_curve(b_streamed),
                tol.schedule_atol)
            claim(f"{m}:streamed_identical", close,
                  f"max pointwise loss divergence stacked vs streamed "
                  f"dispatch: {div:.2e} (atol {tol.schedule_atol}, bitwise)")
        else:
            claim(f"{m}:streamed_identical", False,
                  "missing bucketed stacked/streamed run pair")

        # -- Assumption 3.1 on live gradients (all probed compressed runs) --
        probed = worst_a31 = 0
        a31_ok, a31_detail = True, []
        for name, run in runs.items():
            if run["spec"]["model"] != m or run["spec"].get("reducer") not in (
                    "fft", "timedomain"):
                continue
            quantized = run["spec"].get("quantize", True)
            margin = tol.a31_quant_margin if quantized else 0.0
            norm_tol = tol.a31_norm_tol if quantized else 1e-4
            for rec in run["records"]:
                if "err_ratio" not in rec:
                    continue
                probed += 1
                theta = rec["theta"]
                # the provable bound is sqrt(theta) (DESIGN.md §6); express it
                # through the paper's slack*theta form
                slack = (tol.a31_sqrt_slack * math.sqrt(theta) + margin) / theta
                if not assumption31_holds_stats(
                        rec["err_ratio"], rec["norm_ratio"], theta, slack, norm_tol):
                    a31_ok = False
                    worst_a31 += 1
                    if len(a31_detail) < 3:
                        a31_detail.append(
                            f"{name}@{rec['step']}: err {rec['err_ratio']:.3f} "
                            f"norm {rec['norm_ratio']:.3f} theta {theta}")
        claim(f"{m}:assumption31", a31_ok and probed > 0,
              f"{probed} probed steps, {worst_a31} violations"
              + (f" ({'; '.join(a31_detail)})" if a31_detail else ""))

        # -- Thm 3.4 envelope on every run of this model --
        env_ok, env_detail = True, []
        for name, run in runs.items():
            if run["spec"]["model"] != m:
                continue
            spec = run["spec"]
            # guard-skipped steps committed no update and their measured
            # gradient energy is the POISONED gradient's (NaN by design on
            # nan_grad rows) — the envelope bounds the committed trajectory
            recs = [r for r in run["records"] if not r.get("skipped")]
            loss = [r["loss"] for r in recs]
            gsq = [r["grad_sq"] for r in recs]
            thetas = [r["theta"] or 0.0 for r in recs]
            constants = estimate_curve_constants(
                loss, gsq, eta=spec["lr"], batch=spec["global_batch"],
                fstar=run.get("entropy_floor", 0.0))
            env = thm34_envelope(
                gsq, constants, eta=spec["lr"], theta=max(thetas),
                batch=spec["global_batch"], slack=tol.thm34_slack)
            if not env.holds:
                env_ok = False
                if len(env_detail) < 3:
                    worst = max(
                        ms - b for ms, b in zip(env.min_so_far, env.bounds))
                    env_detail.append(f"{name}: exceeds bound by {worst:.3g}")
        claim(f"{m}:thm34_envelope", env_ok,
              "measured min grad-energy under the plug-in Thm 3.4 bound"
              + (f" EXCEPT {'; '.join(env_detail)}" if env_detail else ""))

    claims += chaos_claims(runs, tol)
    return claims, all(c.passed for c in claims)
