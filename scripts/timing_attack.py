#!/usr/bin/env python
"""End-to-end HQC key recovery through the MEASURED timing channel.

Runs ``simulate_hqc_idealized_oracle`` with ``oracle_backend="timing"``:
every oracle decision comes from differential cycle-timed decapsulations of
the native HQC implementation (the rejection-sampling side channel the
reference only characterizes, hqc_eval_oracle.py / hqc.rs:175-200 — it never
drives its attack from it).  Emits a JSON artifact with the calibration,
decision counts, physical decapsulation counts, live accuracy vs ground
truth, and wall time.

Example (the BASELINE.md artifact run):
    python scripts/timing_attack.py --out artifacts/hqc128_timing_attack.json \
        --key-file fixtures/test-hqc128.key --seed 1 --measure 64
"""

import argparse
import json
import logging
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True, help="JSON artifact path")
    ap.add_argument("--csv", default=None, help="optional stats CSV (appended)")
    ap.add_argument("--key-file", default="fixtures/test-hqc128.key")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--param-set", default="128")
    ap.add_argument("--code-weight", type=int, default=20)
    ap.add_argument("--decode-every", type=int, default=50)
    ap.add_argument("--measure", type=int, default=64,
                    help="cycle-timed decapsulations per class per decision")
    ap.add_argument("--profile-log2", type=int, default=14)
    ap.add_argument("--calibration-trials", type=int, default=150)
    ap.add_argument("--max-oracle-calls", type=int, default=None)
    ap.add_argument("--pt-target", type=int, default=3,
                    help="extra seed expansions required of the attack "
                         "plaintext (3 is the maximum this sampler can "
                         "produce: extras are Binomial(3, ~0.18))")
    ap.add_argument("--decode-backend", default="circulant",
                    choices=["general", "padded", "circulant"])
    ap.add_argument("--platform", default="default", choices=["cpu", "default"])
    ap.add_argument("--recal-every", type=int, default=1200,
                    help="oracle decisions between mid-attack drift "
                         "recalibrations (0 disables)")
    ap.add_argument("--recal-trials", type=int, default=20,
                    help="known-class probes per class per recalibration")
    ap.add_argument("--checkpoint", default=None,
                    help="pickle the full attack state here at every clean "
                         "point so a killed run can be continued")
    ap.add_argument("--resume", action="store_true",
                    help="continue from an existing --checkpoint file "
                         "(skips profiling; recalibrates the channel once)")
    args = ap.parse_args()

    if args.platform == "cpu":
        import jax

        jax.config.update("jax_platforms", "cpu")

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")

    from _timing_common import (
        channel_fields,
        start_partial_writer,
        write_json,
    )

    from sca_ldpc_tpu.models.hqc import simulate_hqc_idealized_oracle
    from sca_ldpc_tpu.models.hqc.tracking import HqcSimulationTracking
    from sca_ldpc_tpu.utils import (
        enable_persistent_compilation_cache,
        make_random_state,
    )

    enable_persistent_compilation_cache()

    t0 = time.time()
    tracking_box = {}
    orig_init = HqcSimulationTracking.__init__

    def spy_init(self, *a, **kw):
        orig_init(self, *a, **kw)
        tracking_box.setdefault("tracking", self)

    HqcSimulationTracking.__init__ = spy_init

    def base_artifact():
        return {
            "experiment": "hqc_timing_attack",
            "param_set": args.param_set,
            "key_file": args.key_file,
            "seed": args.seed,
            "code_weight": args.code_weight,
            "decode_every": args.decode_every,
            "timing_measure": args.measure,
            "pt_target": args.pt_target,
            "profile_measurements": 2**args.profile_log2,
            "recal_every": args.recal_every,
            "decode_backend": args.decode_backend,
        }

    def snapshot():
        art = base_artifact()
        art["wall_seconds"] = round(time.time() - t0, 1)
        tr = tracking_box.get("tracking")
        if tr is not None:
            art.update(channel_fields(tr))
        return art

    stop_partial = start_partial_writer(args.out, snapshot, interval=60)
    try:
        ok, tracking = simulate_hqc_idealized_oracle(
            make_random_state(args.seed),
            args.decode_every,
            args.code_weight,
            args.key_file,
            0.0,
            args.param_set,
            max_oracle_calls=args.max_oracle_calls,
            oracle_backend="timing",
            decode_backend=args.decode_backend,
            timing_measure=args.measure,
            timing_profile_measurements=2**args.profile_log2,
            timing_calibration_trials=args.calibration_trials,
            timing_pt_target=args.pt_target,
            timing_recal_every=args.recal_every,
            timing_recal_trials=args.recal_trials,
            checkpoint_path=args.checkpoint,
            resume=args.resume,
        )
    finally:
        stop_partial()
        HqcSimulationTracking.__init__ = orig_init
    wall = time.time() - t0

    stats = tracking.decoder_stats[-1] if tracking.decoder_stats else {}
    artifact = base_artifact()
    calib = getattr(tracking, "timing_calibration", None)
    artifact.update({
        "calibrated_epsilon": (
            list(calib["initial_epsilon"]) if calib
            else list(tracking.params.EPSILON)
        ),
        "success": bool(ok),
        "wall_seconds": round(wall, 1),
        "decoder_stats_last": {k: (bool(v) if isinstance(v, bool) else v)
                               for k, v in stats.items()},
    })
    artifact.update(channel_fields(tracking))
    write_json(args.out, artifact)
    print(json.dumps(artifact))

    if args.csv:
        tracking.append_stats_csv(args.csv, label="timing")


if __name__ == "__main__":
    main()
