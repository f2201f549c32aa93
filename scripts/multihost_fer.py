#!/usr/bin/env python
"""Multi-process (multi-host) sharded FER simulation driver.

The reference scales across machines by launching independent processes and
merging CSV files (run-parallel-hqc-simulation.sh:10-45).  Here N processes
form ONE SPMD program: every process runs this script with the same
arguments plus its own ``--process-id``; ``jax.distributed`` connects them,
the devices of all processes form a single global mesh, and the sharded FER
step (parallel/fer.py) runs with XLA-inserted cross-process collectives for
the success/convergence reductions.

On a real cluster each process is one host and the devices are its local
GPUs (run with no ``--force-cpu-devices``).  On one host, one process drives
all of its cards: do not start one process per card, because every JAX
process reserves most of the memory of each card it can see, so a second
process on the same host fails.  For development and CI this
script also runs multi-process on CPU: ``--force-cpu-devices K`` gives each
process K virtual CPU devices (gloo collectives), so a 2-process x 4-device
run exercises exactly the code path of a 2-host cluster — and its sampled
errors (hence FER counts) are bit-identical to a single-process 8-device
run, which tests/test_parallel.py asserts.

Example (two terminals or subprocesses):

    python scripts/multihost_fer.py --coordinator localhost:9876 \
        --num-processes 2 --process-id 0 --force-cpu-devices 4 ...
    python scripts/multihost_fer.py ... --process-id 1 ...

Process 0 prints one JSON line with the globally-reduced results.
"""

import argparse
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--coordinator", default=None,
                    help="coordinator address host:port (required if num-processes > 1)")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--force-cpu-devices", type=int, default=0, metavar="K",
                    help="run on K virtual CPU devices per process (development / CI); "
                         "0 = use the real local platform")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--runs", type=int, default=512)
    ap.add_argument("--n", type=int, default=257, help="circulant size")
    ap.add_argument("--code-weight", type=int, default=5)
    ap.add_argument("--error-rate", type=float, default=0.01)
    ap.add_argument("--max-iter", type=int, default=30)
    ap.add_argument("--model", type=int, default=1, help="mesh model-axis size")
    args = ap.parse_args(argv)

    # Platform config must precede any backend initialization.
    if args.force_cpu_devices:
        flags = [
            f for f in os.environ.get("XLA_FLAGS", "").split()
            if "xla_force_host_platform_device_count" not in f
        ]
        flags.append(
            f"--xla_force_host_platform_device_count={args.force_cpu_devices}"
        )
        os.environ["XLA_FLAGS"] = " ".join(flags)
    import jax

    if args.force_cpu_devices:
        jax.config.update("jax_platforms", "cpu")
        if args.num_processes > 1:
            # cross-process collectives on the CPU backend
            jax.config.update("jax_cpu_collectives_implementation", "gloo")

    if args.num_processes > 1:
        os.environ.setdefault("JAX_COORDINATOR_ADDRESS", args.coordinator or "")
    from sca_ldpc_tpu.parallel import init_distributed, make_mesh, sharded_fer_simulation
    from sca_ldpc_tpu.codes.layout import CirculantLayout
    from sca_ldpc_tpu.codes.make_code import random_circulant_first_row
    from sca_ldpc_tpu.utils import make_random_state

    if args.num_processes > 1:
        init_distributed(args.coordinator, args.num_processes, args.process_id)

    import numpy as np

    first_row = random_circulant_first_row(
        args.n, args.code_weight, make_random_state(args.seed)
    )
    layout = CirculantLayout.from_first_row(first_row, with_identity=True)
    probs = np.full(layout.n_vars, args.error_rate, np.float32)

    mesh = make_mesh(model=args.model)  # global mesh over ALL processes' devices
    successes, frames = sharded_fer_simulation(
        layout, probs, args.runs, jax.random.PRNGKey(args.seed), mesh,
        max_iter=args.max_iter,
    )

    if jax.process_index() == 0:
        print(json.dumps({
            "successes": int(successes),
            "frames": int(frames),
            "fer": round(1.0 - successes / frames, 6),
            "process_count": jax.process_count(),
            "device_count": jax.device_count(),
            "mesh": [int(s) for s in mesh.devices.shape],
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
