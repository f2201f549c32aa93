#!/usr/bin/env python
"""Decision-budget model for timing-channel key recoveries (VERDICT r4 #4).

Fits decisions-per-recovered-y-bit as a function of live success-class
accuracy over the completed HQC-128 timing runs, then predicts the decision
budget and wall time for an HQC-192 recovery at candidate channel
accuracies — so a 192 attempt can be scheduled into a window actually
large enough to hold it (three runs have died to round wall-clocks).

Model: log(decisions/bit) = a + b * (1 - acc_success), least squares over
the N=5 completed 128 runs.  The fail class held 0.95-0.97 in every run,
so the success class is the one free variable.  Scaling to 192 uses the
y-weight ratio (100/66 bits); the idealized-oracle call ratio between the
sets (~32k/20k = 1.55 vs 100/66 = 1.52, BASELINE.md round 1) supports
decisions-per-bit being roughly parameter-set invariant at matched
accuracy.  Wall time uses the measured 192 decision rate from the round-4
partial run (19.2 decisions/s through its window, decaps are 2.2x longer
than at 128).

Reads: artifacts/hqc128_timing_attack.json, artifacts/timing_stats/*.json
Writes: artifacts/timing_budget_model.json (+ a markdown table to stdout)
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

Y_BITS = {"128": 66, "192": 100, "256": 131}


def completed_128_runs():
    runs = []
    a = json.load(open("artifacts/hqc128_timing_attack.json"))
    runs.append(("r2-artifact", a["oracle_decisions"],
                 a["live_accuracy_success"]))
    for name in ("128-s2-cpu", "128-s4-tpu"):
        p = f"artifacts/timing_stats/timing_{name}.json"
        a = json.load(open(p))
        assert a["success"] and not a.get("partial")
        runs.append((name, a["oracle_decisions"], a["live_accuracy_success"]))
    b = json.load(open("artifacts/timing_stats/timing_batched_2x128.json"))
    for r in b["runs"]:
        assert r["success"]
        runs.append((f"batched-s{r['seed']}", r["oracle_decisions"],
                     r["live_accuracy_success"]))
    return runs


def main():
    runs = completed_128_runs()
    bits = Y_BITS["128"]
    x = np.array([1.0 - acc for (_n, _d, acc) in runs])
    y = np.log([d / bits for (_n, d, _a) in runs])
    A = np.stack([np.ones_like(x), x], axis=1)
    (a, b), res, *_ = np.linalg.lstsq(A, y, rcond=None)
    pred = A @ np.array([a, b])
    resid = y - pred
    # log-space residual spread -> multiplicative uncertainty band
    sigma = float(np.sqrt(np.mean(resid**2)))

    print("Completed 128 runs (observed vs fit):")
    print(f"{'run':16s} {'acc_s':>6s} {'dec/bit':>8s} {'fit':>8s} {'ratio':>6s}")
    for (name, d, acc), p in zip(runs, pred):
        print(f"{name:16s} {acc:6.3f} {d / bits:8.0f} {np.exp(p):8.0f} "
              f"{d / bits / np.exp(p):6.2f}")
    print(f"\nfit: log(decisions/bit) = {a:.3f} + {b:.3f} * (1 - acc_s)"
          f"   (rms log-residual {sigma:.3f} -> x/{np.exp(sigma):.2f} band)")

    # Measured 192 decision rate: round-4 partial (includes recalibration
    # overhead and accelerator decode rounds; window was degraded, so quiet
    # windows should run slightly faster).
    p192 = json.load(open("artifacts/timing_stats/timing_192-s6-tpu.json"))
    rate = p192["oracle_decisions"] / p192["wall_seconds"]
    bits192 = Y_BITS["192"]

    rows = []
    print(f"\nHQC-192 predictions ({bits192} y-bits, measured rate "
          f"{rate:.1f} decisions/s from the round-4 partial):")
    print(f"{'acc_s':>6s} {'decisions':>10s} {'band':>21s} {'wall':>8s} "
          f"{'band':>15s}")
    for acc in (0.95, 0.90, 0.85, 0.80, 0.75, 0.70):
        d = float(np.exp(a + b * (1.0 - acc)) * bits192)
        lo, hi = d / np.exp(sigma), d * np.exp(sigma)
        w, wlo, whi = d / rate, lo / rate, hi / rate
        rows.append({"acc_success": acc, "decisions": round(d),
                     "decisions_lo": round(lo), "decisions_hi": round(hi),
                     "wall_s": round(w), "wall_lo_s": round(wlo),
                     "wall_hi_s": round(whi)})
        print(f"{acc:6.2f} {d:10.0f} [{lo:9.0f},{hi:9.0f}] "
              f"{w / 3600:6.1f}h [{wlo / 3600:4.1f},{whi / 3600:4.1f}]h")

    artifact = {
        "experiment": "timing_decision_budget_model",
        "model": "log(decisions_per_bit) = a + b*(1-acc_success)",
        "a": float(a), "b": float(b), "rms_log_residual": sigma,
        "fit_runs": [
            {"run": n, "decisions": d, "acc_success": acc,
             "decisions_per_bit": d / bits}
            for (n, d, acc) in runs
        ],
        "hqc192": {
            "y_bits": bits192,
            "measured_rate_decisions_per_s": rate,
            "rate_source": "round-4 partial timing_192-s6-tpu.json",
            "predictions": rows,
        },
    }
    with open("artifacts/timing_budget_model.json", "w") as f:
        json.dump(artifact, f, indent=1)
    print("\nwrote artifacts/timing_budget_model.json")


if __name__ == "__main__":
    main()
