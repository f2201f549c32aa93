#!/usr/bin/env python
"""FER-vs-error-rate curves with CPU-reference comparison.

Produces the statistical FER-equivalence evidence BASELINE.md calls for:
runs the sharded FER step (parallel/fer.py) on the accelerator and the NumPy
reference decoder over a sweep of error rates on the HQC-128 attack code,
writes a CSV and a plot.

    python scripts/fer_curve.py --out fer_curve.csv --runs 2048
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="fer_curve.csv")
    ap.add_argument("--runs", type=int, default=2048)
    ap.add_argument("--cpu-runs", type=int, default=64)
    ap.add_argument("--rates", type=float, nargs="+",
                    default=[0.01, 0.02, 0.03, 0.04, 0.045, 0.05, 0.055, 0.06])
    ap.add_argument("--weight", type=int, default=20)
    ap.add_argument("--max-iter", type=int, default=50)
    ap.add_argument("--plot", default=None, help="optional output plot path")
    args = ap.parse_args()

    import numpy as np
    import jax

    from bench import build_code, circulant_syndrome, cpu_reference_decode
    from sca_ldpc_tpu.parallel.fer import make_sharded_fer_step
    from sca_ldpc_tpu.parallel.mesh import make_mesh

    lay = build_code(weight=args.weight)
    mesh = make_mesh(data=1, model=1, devices=jax.devices()[:1])
    rows = []
    with mesh:
        for rate in args.rates:
            probs = np.full(lay.n_vars, rate, np.float32)
            step = make_sharded_fer_step(
                lay, probs, mesh, max_iter=args.max_iter,
                method="product_sum",
            )
            batch = args.runs
            # exclude compile from timing
            jax.block_until_ready(step(jax.random.PRNGKey(0), batch))
            t0 = time.time()
            ok, _conv, _ = step(jax.random.PRNGKey(int(rate * 1e6)), batch)
            device_fer = 1.0 - int(ok) / batch
            device_dt = time.time() - t0

            # CPU reference on fewer frames (it is ~3 orders slower)
            rng = np.random.RandomState(int(rate * 1e6))
            prior = np.log((1 - probs) / probs).astype(np.float64)
            cpu_ok = 0
            t0 = time.time()
            for _ in range(args.cpu_runs):
                e = (rng.rand(lay.n_vars) < rate).astype(int)
                e_hat, _ = cpu_reference_decode(lay, prior, circulant_syndrome(lay, e),
                                                args.max_iter)
                cpu_ok += int((e_hat == e).all())
            cpu_fer = 1.0 - cpu_ok / args.cpu_runs
            rows.append({
                "error_rate": rate, "device_fer": device_fer, "device_frames": batch,
                "cpu_fer": cpu_fer, "cpu_frames": args.cpu_runs,
            })
            print(f"rate {rate}: device FER {device_fer:.4f} ({batch} frames, {device_dt:.1f}s) "
                  f"| cpu FER {cpu_fer:.4f} ({args.cpu_runs} frames, {time.time()-t0:.1f}s)")

    import pandas as pd

    df = pd.DataFrame(rows)
    df.to_csv(args.out, index=False)
    print(f"wrote {args.out}")
    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.semilogy(df.error_rate, df.device_fer.clip(lower=1e-5), "o-",
                     label=jax.devices()[0].device_kind)
        plt.semilogy(df.error_rate, df.cpu_fer.clip(lower=1e-5), "s--", label="CPU ref")
        plt.xlabel("channel error rate")
        plt.ylabel("frame error rate")
        plt.legend()
        plt.grid(True, which="both", alpha=0.3)
        plt.savefig(args.plot, dpi=150, bbox_inches="tight")
        print(f"wrote {args.plot}")


if __name__ == "__main__":
    main()
