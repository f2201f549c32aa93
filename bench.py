#!/usr/bin/env python
"""Decoder benchmark on one NVIDIA GPU: decoded frames/s on the HQC-128
parity-check code.

Workload: syndrome BP decode of the HQC-128 attack code
[circulant(N=17669, weight=20) | I_N] (35,338 columns), product-sum, up to 30
iterations with per-frame early termination, error rate 0.01 — the hot loop
of both the FER simulations (decode.py:130-177) and the attack's periodic
decode (hqc.py:661-759).  The timed program is the sharded FER step
(parallel/fer.py: sample -> syndrome -> rolled-plane XLA decode -> compare)
on a one-device mesh, batch 4096.

Baseline: the reference's decoder is the ldpc PyPI package's C bp_decoder
driven one frame per Python call (not installed here; its per-frame
edge-sweep structure is reproduced as a vectorized NumPy reference decoder,
which is generous to it), timed in the same run.

``--full`` adds the q-ary medium decoder (N450 R150 B7) and the Kyber-768
two-alphabet decoder (N1280 R512 SW6), both batch 4096, 10 iterations.

Every timing is the median over repeated windows, each ended by
``block_until_ready``.  Refuses to run unless JAX's default device is a GPU;
prints the device and the card's power limit on stderr and exactly one JSON
line on stdout: {"metric", "value", "unit", "vs_baseline"}.
"""

import json
import sys
import time

import numpy as np

WINDOWS = 7


def build_code(seed=0, n=17669, weight=20):
    from sca_ldpc_tpu.codes.layout import CirculantLayout
    from sca_ldpc_tpu.codes.make_code import random_circulant_first_row
    from sca_ldpc_tpu.utils import make_random_state

    first_row = random_circulant_first_row(n, weight, make_random_state(seed))
    return CirculantLayout.from_first_row(first_row, with_identity=True)


# ---------------------------------------------------------------------------
# CPU reference: per-frame product-sum BP with the same schedule/early exit
# ---------------------------------------------------------------------------


def cpu_reference_decode(lay, prior_llr, syndrome, max_iter=30):
    """One frame, NumPy product-sum syndrome BP on the circulant layout."""
    n = lay.n
    w = lay.weight
    shifts = np.asarray(lay.shifts)
    pc = prior_llr[:n]
    pi = prior_llr[n:]
    v2c = np.stack([np.roll(pc, k) for k in shifts])  # [w, n] check-major
    sgn_syn = 1.0 - 2.0 * syndrome

    def phi(x):
        x = np.clip(x, 1e-9, 60.0)
        return -np.log(np.tanh(0.5 * x))

    e_c = (pc < 0).astype(int)
    e_i = (pi < 0).astype(int)
    it = -1
    for it in range(max_iter):
        planes = np.concatenate([v2c, pi[None, :]], axis=0)  # [w+1, n]
        sgn = np.where(planes >= 0, 1.0, -1.0)
        mag = np.abs(planes)
        total_sign = sgn.prod(axis=0) * sgn_syn
        pm = phi(mag)
        total_pm = pm.sum(axis=0)
        c2v = (total_sign * sgn) * phi(np.maximum(total_pm - pm, 1e-9))
        c2v_c, c2v_i = c2v[:w], c2v[w]
        c2v_var = np.stack([np.roll(c2v_c[t], -k) for t, k in enumerate(shifts)])
        total_c = pc + c2v_var.sum(axis=0)
        v2c_var = np.clip(total_c[None, :] - c2v_var, -60, 60)
        v2c = np.stack([np.roll(v2c_var[t], k) for t, k in enumerate(shifts)])
        total_i = pi + c2v_i
        e_c = (total_c < 0).astype(int)
        e_i = (total_i < 0).astype(int)
        syn = (sum(np.roll(e_c, k) for k in shifts) + e_i) % 2
        if (syn == syndrome).all():
            break
    return np.concatenate([e_c, e_i]), it + 1


def circulant_syndrome(lay, errors):
    """Syndrome of one [n_vars] error vector (host side)."""
    return (sum(np.roll(errors[: lay.n], k) for k in lay.shifts) + errors[lay.n:]) % 2


def bench_cpu(lay, probs, error_rate, frames=4, max_iter=30, seed=0):
    """Per-frame CPU reference rate.  The rate is taken from the FASTEST
    frame (least host contention) — the measurement most generous to the
    baseline."""
    rng = np.random.RandomState(seed)
    n_vars = lay.n_vars
    prior = np.log((1 - probs) / probs).astype(np.float64)
    ok = 0
    best = float("inf")
    for _ in range(frames):
        e = (rng.rand(n_vars) < error_rate).astype(int)
        syn = circulant_syndrome(lay, e)
        t0 = time.perf_counter()
        e_hat, _iters = cpu_reference_decode(lay, prior, syn, max_iter)
        best = min(best, time.perf_counter() - t0)
        ok += int((e_hat == e).all())
    return 1.0 / best, ok / frames


# ---------------------------------------------------------------------------
# Device paths
# ---------------------------------------------------------------------------


def median_window(run, windows=WINDOWS):
    """Call ``run(i)`` for ``windows`` windows, each ended by
    ``block_until_ready``.  Returns (median seconds, [q1, q3], last output)."""
    import jax

    times, out = [], None
    for i in range(windows):
        t0 = time.perf_counter()
        out = jax.block_until_ready(run(i))
        times.append(time.perf_counter() - t0)
    q1, med, q3 = np.percentile(times, [25, 50, 75])
    return float(med), [float(q1), float(q3)], out


def bench_fer_step(lay, error_rate, batch=4096, max_iter=30, windows=WINDOWS):
    """Frames/s of the one-device sharded FER step; returns
    (frames/s, [q1, q3] frames/s, success fraction of the last window)."""
    import jax

    from sca_ldpc_tpu.parallel.fer import make_sharded_fer_step
    from sca_ldpc_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(data=1, model=1, devices=jax.devices()[:1])
    probs = np.full(lay.n_vars, error_rate, np.float32)
    step = make_sharded_fer_step(lay, probs, mesh, max_iter=max_iter)
    jax.block_until_ready(step(jax.random.PRNGKey(0), batch))  # compile
    med, (q1, q3), (ok, _conv, _it) = median_window(
        lambda i: step(jax.random.PRNGKey(1 + i), batch), windows)
    return batch / med, [batch / q3, batch / q1], int(ok) / batch


def qary_medium_decoder():
    """Criterion 'medium decoder' equivalent (benches/decoder.rs:66-92):
    N=450 R=150 DV=3 DC=7 B=7 Q=15, 10 iterations."""
    from sca_ldpc_tpu.codes import make_regular_ldpc_parity_check_matrix_identity
    from sca_ldpc_tpu.ops import QaryDecoder
    from sca_ldpc_tpu.utils import make_random_state

    H = make_regular_ldpc_parity_check_matrix_identity(
        300, 150, 3, 6, make_random_state(1)).astype(np.int8)
    return QaryDecoder(H, b_range=7, max_iter=10)


def kyber_decoder():
    """Kyber-768 production decoder (DecoderN1280R512SW6 equivalent,
    lib.rs:65-75): two-alphabet min-sum, 10 iterations."""
    from sca_ldpc_tpu.models.kyber import gen_ldpc_matrix, get_decoder

    return get_decoder(6, gen_ldpc_matrix(6, 0, check_blocks=2), 2, iterations=10)


def qary_medium_channel(batch):
    """All-zero codeword with one weak wrong symbol per frame."""
    channel = np.zeros((batch, 450, 15), np.float32)
    channel[:, :, 7] = 1.0
    channel[:, 1, 7] = 0.1
    channel[:, 1, 14] = 0.9
    return channel


def kyber_channel(batch):
    """All-zero secret and check sums, peaked posteriors."""
    ch_b = np.full((batch, 768, 5), 0.02, np.float32)
    ch_b[:, :, 2] = 0.92
    ch_s = np.zeros((batch, 512, 25), np.float32)
    ch_s[:, :, 12] = 1.0
    return ch_b, ch_s


def bench_decoder(decode, args, batch, windows=WINDOWS):
    """Decodes/s of ``jit(decode)(*args)`` with ``args`` already on the
    device; returns (decodes/s, [q1, q3] decodes/s, all-zero word recovered
    in every frame)."""
    import jax

    decode = jax.jit(decode)
    args = jax.device_put(args)
    jax.block_until_ready(decode(*args))  # compile
    med, (q1, q3), hard = median_window(lambda i: decode(*args), windows)
    return batch / med, [batch / q3, batch / q1], not np.asarray(hard).any()


def main():
    from sca_ldpc_tpu.utils import enable_persistent_compilation_cache
    from sca_ldpc_tpu.utils.device import (
        card_name_and_power_limit,
        describe_devices,
        require_gpu,
    )

    require_gpu("bench.py")
    enable_persistent_compilation_cache()
    print(f"# device: {describe_devices()}", file=sys.stderr)
    print(f"# card (name, power limit): {card_name_and_power_limit()}", file=sys.stderr)

    full = "--full" in sys.argv
    error_rate = 0.01
    max_iter = 30
    lay = build_code()
    probs = np.full(lay.n_vars, error_rate, np.float32)

    cpu_fps, cpu_success = bench_cpu(lay, probs, error_rate, frames=3, max_iter=max_iter)
    print(f"# cpu reference: {cpu_fps:.2f} frames/s, success {cpu_success:.3f}",
          file=sys.stderr)

    fps, iqr, success = bench_fer_step(lay, error_rate, batch=4096, max_iter=max_iter)
    print(f"# hqc128 FER step: {fps:.1f} frames/s (median of {WINDOWS} windows, "
          f"IQR {iqr[0]:.1f}-{iqr[1]:.1f}), success {success:.4f}", file=sys.stderr)

    if full:
        batch = 4096
        dec = qary_medium_decoder()
        qfps, qiqr, qok = bench_decoder(dec.min_sum, (qary_medium_channel(batch),), batch)
        print(f"# qary medium decoder (N450 R150 B7 Q15, 10 iters): "
              f"{qfps:.1f} decodes/s (IQR {qiqr[0]:.1f}-{qiqr[1]:.1f}), "
              f"correct={qok}", file=sys.stderr)
        kdec = kyber_decoder()
        kfps, kiqr, kok = bench_decoder(kdec.min_sum, kyber_channel(batch), batch)
        print(f"# kyber-768 decoder (N1280 R512 SW6, 10 iters): "
              f"{kfps:.1f} decodes/s (IQR {kiqr[0]:.1f}-{kiqr[1]:.1f}), "
              f"correct={kok}", file=sys.stderr)

    print(json.dumps({
        "metric": "hqc128_parity_check_decode_frames_per_s_per_chip",
        "value": round(fps, 1),
        "unit": "frames/s/chip (N=35338 cols, product-sum BP to convergence, err 0.01)",
        "vs_baseline": round(fps / cpu_fps, 1),
    }))


if __name__ == "__main__":
    main()
