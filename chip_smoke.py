#!/usr/bin/env python
"""End-to-end smoke run of the HQC attack and its decoders on an NVIDIA GPU.

Drives the main paths once, in this one process (a JAX process reserves most
of the card's memory, so nothing here starts a second one), through the entry
points a user calls, at the published code lengths:

1. ``device``       the card, its power limit, JAX's version, the compile cache;
2. ``fer-hqc128``   the sharded FER step (parallel/fer.py) at N=17,669, w=20,
                    batch 4096: frames/s, hard decisions of 8 frames equal to
                    the NumPy reference (bench.cpu_reference_decode), and the
                    FER at error rate 0.045 within 3 binomial sigma of it;
3. ``fer-hqc256``   N=57,637, w=30: the step's ``memory_analysis()``, batch
                    1024 or the largest power of two that fits, 2 frames equal
                    to the NumPy reference;
4. ``attack-hqc128`` ``hqc_simulate`` through the CLI to full key recovery,
                    with ``--decode-backend circulant`` and with ``general``;
5. ``kyber``        the Kyber-768 two-alphabet and q-ary medium decoders at
                    batch 4096 (all-zero word recovered, decodes/s), their hard
                    decisions on random LLRs equal to the same functions on the
                    CPU backend, and ``kyber_simulate`` recovering fully.

``--four-cards`` runs only ``device`` and ``four-cards``: the sharded FER step
on a 4-card ``data`` mesh against the 1-card step with the same keys (counts
equal, frames/s of both), and ``ShardedCirculantDecodeExecutor(crosscheck=True)``
over 4 HQC-128 attack instances to full recovery, every decode round
bitwise-equal to the single-card path.

Each phase prints one line with its results, wall seconds and the seconds
spent compiling.  A failed check raises, so the script exits non-zero and
never prints the final line, which is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits non-zero before any phase when JAX's default device is not a GPU.

    python chip_smoke.py
    python chip_smoke.py --four-cards
"""

import argparse
import json
import logging
import math
import sys
import time

import numpy as np

FIXTURE_KEY = "fixtures/test-hqc128.key"


class CompileClock:
    """Seconds and count of XLA compilations (persistent-cache loads
    included), from JAX's monitoring events."""

    EVENT = "/jax/core/compile/backend_compile_duration"

    def __init__(self):
        self.seconds = 0.0
        self.count = 0

    def __call__(self, event, duration, **_kwargs):
        if event == self.EVENT:
            self.seconds += duration
            self.count += 1


def require(cond, message):
    if not cond:
        raise AssertionError(message)


def binomial_agree(fail_a, n_a, fail_b, n_b, sigmas=3.0):
    """Do two failure counts agree within ``sigmas`` pooled binomial sigma?"""
    p = (fail_a + fail_b) / (n_a + n_b)
    sigma = math.sqrt(p * (1 - p) * (1 / n_a + 1 / n_b))
    return abs(fail_a / n_a - fail_b / n_b) <= sigmas * sigma


def reference_decisions(lay, error_rate, errors, max_iter):
    """NumPy reference hard decisions for each error frame (rows)."""
    from bench import circulant_syndrome, cpu_reference_decode

    prior = np.full(lay.n_vars, np.log((1 - error_rate) / error_rate), np.float64)
    return np.stack([
        cpu_reference_decode(lay, prior, circulant_syndrome(lay, e), max_iter)[0]
        for e in errors
    ])


def device_decisions(lay, error_rate, errors, max_iter, device=None):
    """The FER step's decoder (parallel/fer.py) on ``errors`` [B, n_vars]."""
    import jax
    import jax.numpy as jnp

    from sca_ldpc_tpu.parallel.fer import circulant_syndrome_decode

    prior = jnp.full((lay.n_vars,), np.log((1 - error_rate) / error_rate), jnp.float32)
    errors = jax.device_put(np.asarray(errors, np.int32), device)
    e_hat, _conv, _it = circulant_syndrome_decode(lay, prior, errors, max_iter, "product_sum")
    return np.asarray(e_hat)


def sampled_errors(lay, error_rate, key, batch, frames):
    """The first ``frames`` of the errors the FER step draws from ``key``."""
    import jax.numpy as jnp

    from sca_ldpc_tpu.parallel.fer import sample_frame_errors

    probs = jnp.full((lay.n_vars,), error_rate, jnp.float32)
    return np.asarray(sample_frame_errors(key, probs, batch)[:frames])


def fer_step(lay, error_rate, max_iter, devices):
    import jax

    from sca_ldpc_tpu.parallel.fer import make_sharded_fer_step
    from sca_ldpc_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(data=len(devices), model=1, devices=devices)
    probs = np.full(lay.n_vars, error_rate, np.float32)
    return make_sharded_fer_step(lay, probs, mesh, max_iter=max_iter)


def phase_device(cache_dir):
    import jax

    from sca_ldpc_tpu.utils.device import card_name_and_power_limit, describe_devices

    card = card_name_and_power_limit()
    print(card)
    d = describe_devices()
    return {"kind": d["kind"], "count": d["count"], "card": card.replace("\n", "; "),
            "jax": jax.__version__, "compile_cache": cache_dir}


def phase_fer(n=17669, weight=20, batch=4096, max_iter=30, rate=0.01,
              exact_frames=8, near_rate=0.045, near_frames=64, windows=3):
    """HQC-sized FER step: throughput, exact decisions far below threshold,
    statistical agreement near it."""
    import jax

    from bench import build_code, median_window

    lay = build_code(seed=0, n=n, weight=weight)
    devices = jax.devices()[:1]
    step = fer_step(lay, rate, max_iter, devices)
    t0 = time.perf_counter()
    jax.block_until_ready(step(jax.random.PRNGKey(0), batch))
    first_call = time.perf_counter() - t0
    med, _iqr, (ok, _conv, iters) = median_window(
        lambda i: step(jax.random.PRNGKey(1 + i), batch), windows)

    key = jax.random.PRNGKey(1)
    errors = sampled_errors(lay, rate, key, batch, exact_frames)
    dev = device_decisions(lay, rate, errors, max_iter)
    ref = reference_decisions(lay, rate, errors, max_iter)
    require((dev == ref).all(), f"{int((dev != ref).any(axis=1).sum())} of "
            f"{exact_frames} frames differ from the NumPy reference at {rate}")

    near = fer_step(lay, near_rate, max_iter, devices)
    key = jax.random.PRNGKey(2)
    ok_near, _c, _i = near(key, batch)
    dev_fail = batch - int(ok_near)
    errors = sampled_errors(lay, near_rate, key, batch, near_frames)
    ref = reference_decisions(lay, near_rate, errors, max_iter)
    dev_same = device_decisions(lay, near_rate, errors, max_iter)
    cpu_fail = int((ref != errors).any(axis=1).sum())
    require(binomial_agree(dev_fail, batch, cpu_fail, near_frames),
            f"FER at {near_rate}: device {dev_fail}/{batch}, "
            f"NumPy {cpu_fail}/{near_frames} (beyond 3 sigma)")
    return {
        "n": n, "w": weight, "batch": batch, "frames_per_s": round(batch / med, 1),
        "first_call_s": round(first_call, 2), "success": int(ok) / batch,
        "last_iters": int(iters), "exact_frames_equal": exact_frames,
        f"fer_device@{near_rate}": round(dev_fail / batch, 4),
        f"fer_numpy@{near_rate}": round(cpu_fail / near_frames, 4),
        "same_decisions_near": f"{int((dev_same == ref).all(axis=1).sum())}/{near_frames}",
    }


def phase_fer_large(n=57637, weight=30, batch=1024, max_iter=30, rate=0.01,
                    exact_frames=2):
    """Largest code: compile first, print memory_analysis, shrink the batch
    by powers of two until it fits the device."""
    import jax

    from bench import build_code

    lay = build_code(seed=0, n=n, weight=weight)
    device = jax.devices()[0]
    step = fer_step(lay, rate, max_iter, [device])
    key = jax.random.PRNGKey(3)
    stats = device.memory_stats() or {}
    limit = stats.get("bytes_limit")
    while True:
        compiled = step.lower(key, batch).compile()
        mem = compiled.memory_analysis()
        need = (mem.temp_size_in_bytes + mem.argument_size_in_bytes
                + mem.output_size_in_bytes)
        print(f"  fer-hqc{n} batch {batch}: memory_analysis {mem}")
        if limit is None or need <= 0.9 * limit or batch == 1:
            break
        batch //= 2
    t0 = time.perf_counter()
    ok, _conv, iters = jax.block_until_ready(compiled(key))
    run_s = time.perf_counter() - t0

    errors = sampled_errors(lay, rate, key, batch, exact_frames)
    dev = device_decisions(lay, rate, errors, max_iter)
    ref = reference_decisions(lay, rate, errors, max_iter)
    require((dev == ref).all(), f"HQC-{n} frames differ from the NumPy reference")
    return {
        "n": n, "w": weight, "batch": batch,
        "temp_bytes": mem.temp_size_in_bytes, "bytes_limit": limit,
        "frames_per_s": round(batch / run_s, 1), "success": int(ok) / batch,
        "iters": int(iters), "exact_frames_equal": exact_frames,
    }


def run_cli(argv):
    """One CLI command in this process; returns the command's result."""
    from sca_ldpc_tpu.cli.main import Commands

    cmds = Commands()
    args = cmds.parse_arguments(argv)
    logging.getLogger().setLevel(logging.WARNING)
    return cmds.run(args)


def phase_attack(decode_backend, key_file=FIXTURE_KEY):
    success, tracking = run_cli([
        "hqc_simulate", "--seed", "0", "--key-file", key_file,
        "--decode-every", "50", "--code-weight", "20",
        "--decode-backend", decode_backend,
    ])
    last = tracking.decoder_stats[-1]
    require(success and last["success"] and last["bad_flips"] == 0,
            f"key not recovered with --decode-backend {decode_backend}: {last}")
    return {"decode_backend": decode_backend,
            "oracle_calls": tracking.num_oracle_calls,
            "decode_calls": len(tracking.decoder_stats),
            "checks": last["checks"], "good_flips": last["good_flips"]}


def dyadic_llrs(rng, shape):
    """Random min-sum LLRs in steps of 1/8 with a zero per row: every sum of
    them is exact in float32, so any two correct backends agree bitwise."""
    llr = rng.randint(0, 64, size=shape).astype(np.float32) / 8
    return llr - llr.min(axis=-1, keepdims=True)


def phase_kyber(batch=4096, compare_batch=16, kyber_runs=2, windows=5):
    import jax

    from bench import (
        bench_decoder,
        kyber_channel,
        kyber_decoder,
        qary_medium_channel,
        qary_medium_decoder,
    )

    out = {"batch": batch}
    kdec, qdec = kyber_decoder(), qary_medium_decoder()
    kfps, _k, k_ok = bench_decoder(kdec.min_sum, kyber_channel(batch), batch, windows)
    qfps, _q, q_ok = bench_decoder(qdec.min_sum, (qary_medium_channel(batch),), batch, windows)
    require(k_ok, "Kyber-768 decoder missed the all-zero word")
    require(q_ok, "q-ary medium decoder missed the all-zero word")
    out.update(kyber_decodes_per_s=round(kfps, 1), qary_decodes_per_s=round(qfps, 1))

    rng = np.random.RandomState(0)
    llr_b = dyadic_llrs(rng, (compare_batch, kdec.n_b, 2 * kdec.b + 1))
    llr_s = dyadic_llrs(rng, (compare_batch, kdec.r, 2 * kdec.bsum + 1))
    llr_q = dyadic_llrs(rng, (compare_batch, qdec.layout.n, qdec.q))
    hard_k = np.asarray(kdec.min_sum_llr(llr_b, llr_s))
    hard_q = np.asarray(qdec.min_sum_llr(llr_q))
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        kdec_cpu, qdec_cpu = kyber_decoder(), qary_medium_decoder()
        cpu_k = np.asarray(kdec_cpu.min_sum_llr(*jax.device_put((llr_b, llr_s), cpu)))
        cpu_q = np.asarray(qdec_cpu.min_sum_llr(jax.device_put(llr_q, cpu)))
    require((hard_k == cpu_k).all(), "Kyber decisions differ from the CPU backend")
    require((hard_q == cpu_q).all(), "q-ary decisions differ from the CPU backend")
    out["cpu_backend_equal"] = f"{compare_batch}+{compare_batch}"

    if kyber_runs:
        results = run_cli(["kyber_simulate", "--seed", "0", "--runs", str(kyber_runs),
                           "--error-rate", "0.005"])
        recovered = sum(r["recovered"] for r in results)
        require(recovered == len(results),
                f"kyber_simulate recovered {recovered}/{len(results)}")
        out["kyber_simulate_recovered"] = f"{recovered}/{len(results)}"
    return out


def phase_four_cards(n=17669, weight=20, batch=4096, max_iter=30, cards=4,
                     attack_oracle_calls=None, windows=3):
    """Sharded FER step and sharded attack decode against one card."""
    import jax

    from bench import build_code, median_window
    from sca_ldpc_tpu.models.hqc.batched import (
        ShardedCirculantDecodeExecutor,
        simulate_hqc_attacks_batched,
    )
    from sca_ldpc_tpu.parallel.mesh import make_mesh

    devices = jax.devices()
    require(len(devices) >= cards, f"needs {cards} devices, has {len(devices)}")
    lay = build_code(seed=0, n=n, weight=weight)
    out = {"cards": cards, "batch": batch}
    for rate in (0.01, 0.045):
        key = jax.random.PRNGKey(4)
        steps = {c: fer_step(lay, rate, max_iter, devices[:c]) for c in (cards, 1)}
        counts = {c: [int(v) for v in jax.block_until_ready(step(key, batch))[:2]]
                  for c, step in steps.items()}
        require(counts[cards] == counts[1], f"{cards}-card (successes, converged) "
                f"{counts[cards]} != 1-card {counts[1]} at {rate}")
        out[f"successes@{rate}"], out[f"converged@{rate}"] = counts[cards]
        if rate == 0.01:
            for c, step in steps.items():
                med, _iqr, _ = median_window(
                    lambda i, step=step: step(jax.random.PRNGKey(10 + i), batch), windows)
                out[f"frames_per_s_{c}card"] = round(batch / med, 1)

    mesh = make_mesh(data=cards, model=1, devices=devices[:cards])
    executor = ShardedCirculantDecodeExecutor(cards, mesh, max_iter=50, crosscheck=True)
    results, rounds = simulate_hqc_attacks_batched(
        list(range(1, cards + 1)), 50, 20, max_oracle_calls=attack_oracle_calls,
        decode_backend="circulant", executor=executor,
    )
    require(rounds > 0, "no sharded decode round ran")
    require(all(r is not None for r in results), "an attack instance died")
    recovered = sum(bool(r[0]) for r in results)
    if attack_oracle_calls is None:
        require(recovered == cards, f"sharded attack recovered {recovered}/{cards} keys")
    out.update(attack_instances=cards, sharded_rounds_bitwise_equal=rounds,
               keys_recovered=recovered)
    return out


def run_phases(phases, clock):
    for name, fn in phases:
        t0 = time.perf_counter()
        c_s, c_n = clock.seconds, clock.count
        try:
            result = fn()
        except BaseException:
            print(f"[{name}] FAILED after {time.perf_counter() - t0:.1f} s", flush=True)
            raise
        fields = " ".join(f"{k}={v}" for k, v in result.items())
        print(f"[{name}] ok {fields} seconds={time.perf_counter() - t0:.1f} "
              f"compile_seconds={clock.seconds - c_s:.1f} compiles={clock.count - c_n}",
              flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card phase (needs 4 GPUs)")
    args = ap.parse_args(argv)

    import jax

    from sca_ldpc_tpu.utils import enable_persistent_compilation_cache
    from sca_ldpc_tpu.utils.device import describe_devices, require_gpu

    require_gpu("chip_smoke.py")
    cache_dir = enable_persistent_compilation_cache()
    clock = CompileClock()
    jax.monitoring.register_event_duration_secs_listener(clock)

    phases = [("device", lambda: phase_device(cache_dir))]
    if args.four_cards:
        phases.append(("four-cards", phase_four_cards))
    else:
        phases += [
            ("fer-hqc128", phase_fer),
            ("fer-hqc256", phase_fer_large),
            ("attack-hqc128-circulant", lambda: phase_attack("circulant")),
            ("attack-hqc128-general", lambda: phase_attack("general")),
            ("kyber", phase_kyber),
        ]
    run_phases(phases, clock)
    print(json.dumps({"ok": True, "device": describe_devices()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
