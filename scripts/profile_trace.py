#!/usr/bin/env python
"""Capture a JAX profiler trace of the HQC-128 FER step.

The traced step is the sharded FER step of parallel/fer.py on a one-device
mesh (sample errors -> syndromes -> rolled-plane BP decode -> compare), the
same program bench.py times.  Writes a TensorBoard-compatible trace
directory (XPlane protos), readable with ``jax.profiler.ProfileData``.

    python scripts/profile_trace.py --out trace
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="trace")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--error-rate", type=float, default=0.01)
    args = ap.parse_args()

    import jax
    import numpy as np

    from bench import build_code
    from sca_ldpc_tpu.parallel.fer import make_sharded_fer_step
    from sca_ldpc_tpu.parallel.mesh import make_mesh

    lay = build_code()
    probs = np.full(lay.n_vars, args.error_rate, np.float32)
    mesh = make_mesh(data=1, model=1, devices=jax.devices()[:1])
    step = make_sharded_fer_step(lay, probs, mesh, max_iter=30)

    # compile outside the trace
    jax.block_until_ready(step(jax.random.PRNGKey(0), args.batch))

    with jax.profiler.trace(args.out):
        for i in range(args.steps):
            out = step(jax.random.PRNGKey(i + 1), args.batch)
        jax.block_until_ready(out)
    print(f"trace written to {args.out}")


if __name__ == "__main__":
    main()
