"""Batched multi-instance HQC attacks.

Runs I independent attack instances (each with its own key, RNG, plaintexts
and check set) concurrently, batching their periodic LDPC decodes into one
vmapped device call (SURVEY §7.4: "many independent attack instances batched
across devices").  The adaptive per-instance control flow stays on host
threads; the device sees a single ``[I, R_pad, ...]`` decode.

The orchestration is a barrier batcher: an instance reaching a decode point
blocks until every live instance has one pending (instances advance at
matched cadences — one decode per DECODE_EVERY checks), then the last
arrival runs the batched decode for everyone.  Instances that finish
deregister, shrinking the barrier.
"""

import logging
import threading

import numpy as np

from ...ops.binary_bp import _bp_decode_syndrome
from ...utils import make_random_state
from .attack import make_params, simulate_hqc_idealized_oracle

logger = logging.getLogger(__name__)


def _batched_decode_received(layouts, channels, msgs, max_iter=100, method="product_sum"):
    """vmapped received-vector BP decode over per-instance layouts.

    All instances must share (R_pad, N, DC) — guaranteed by bucketing to the
    batch-wide maximum.
    """
    import jax
    import jax.numpy as jnp

    chk_var = jnp.stack([jnp.asarray(l.chk_var) for l in layouts])
    chk_mask = jnp.stack([jnp.asarray(l.chk_mask) for l in layouts])
    var_flat = jnp.stack([jnp.asarray(l.var_flat) for l in layouts])
    var_mask = jnp.stack([jnp.asarray(l.var_mask) for l in layouts])
    prior = jnp.stack(
        [jnp.asarray(np.log((1 - c) / c), jnp.float32) for c in channels]
    )
    z = jnp.stack([jnp.asarray(m, jnp.int32) for m in msgs])
    dc = layouts[0].dc
    r = layouts[0].r

    def one(chk_var, chk_mask, var_flat, var_mask, prior, z):
        z_pad = jnp.concatenate([z, jnp.zeros((1,), jnp.int32)], axis=-1)
        bits = jnp.take(z_pad, chk_var.reshape(-1), axis=-1).reshape(r, dc)
        syn = jnp.sum(jnp.where(chk_mask, bits, 0), axis=-1) % 2
        e, conv, it = _bp_decode_syndrome(
            chk_var, chk_mask, var_flat, var_mask, prior, syn[None], max_iter, method, dc
        )
        return (z + e[0]) % 2

    decoded = jax.vmap(one)(chk_var, chk_mask, var_flat, var_mask, prior, z)
    return np.asarray(decoded)


def _shared_p_pad(items):
    """Bucketed plaintext-block pad shared by a batch of masked-circulant
    decoders — stable as the running max P creeps up round-to-round (same
    rationale as MaskedCirculantCheckDecoder.P_BUCKET).  All instances
    must agree on the bucket size: an instance-level P_BUCKET override on
    just one decoder would otherwise silently set the whole batch's pad
    shape (advisor finding, round 4)."""
    buckets = {dec.P_BUCKET for _tid, (dec, _t, _c, _y) in items}
    assert len(buckets) == 1, (
        f"batched instances disagree on P_BUCKET: {sorted(buckets)}"
    )
    return items[0][1][0].bucketed_p(
        max(len(dec._block_shifts) for _tid, (dec, _t, _c, _y) in items)
    )


class BatchedDecodeExecutor:
    """Barrier batcher: collects one pending decode per live instance, runs
    them as a single vmapped call, distributes results."""

    def __init__(self, num_instances, max_iter=100, method="product_sum"):
        self._lock = threading.Condition()
        self._live = num_instances
        self._pending = {}  # thread ident -> (decoder, tracking, checks, y_sparse)
        self._results = {}
        self._generation = 0
        self.max_iter = max_iter
        self.method = method
        self.batched_calls = 0

    def deregister(self):
        with self._lock:
            self._live -= 1
            if self._pending and len(self._pending) >= self._live:
                self._run_batch_locked()
                self._lock.notify_all()

    def decode(self, decoder, tracking, checks, y_sparse) -> bool:
        me = threading.get_ident()
        with self._lock:
            gen = self._generation
            self._pending[me] = (decoder, tracking, list(checks), list(y_sparse))
            if len(self._pending) >= self._live:
                self._run_batch_locked()
                self._lock.notify_all()
            else:
                self._lock.wait_for(
                    lambda: me in self._results or self._generation > gen
                )
            result = self._results.pop(me)
            if isinstance(result, BaseException):
                raise result
            return result

    def _run_batch_locked(self):
        items = list(self._pending.items())
        self._pending.clear()
        self._generation += 1
        self.batched_calls += 1
        try:
            self._execute(items)
        except BaseException as e:  # propagate to every waiter
            for tid, _ in items:
                self._results[tid] = e

    def _target_shape(self, items):
        from .attack import _bucket

        r_pad = max(_bucket(len(checks)) for _tid, (_d, _t, checks, _y) in items)
        dv = max(dec.needed_dv() for _tid, (dec, _t, _c, _y) in items)
        return r_pad, dv

    def _execute(self, items):
        r_pad, dv = self._target_shape(items)
        builds = [
            (tid, dec, tr, checks, y, *dec.build_arrays(checks, y, r_pad=r_pad, dv=dv))
            for tid, (dec, tr, checks, y) in items
        ]
        layouts = [b[5] for b in builds]
        channels = [b[6] for b in builds]
        msgs = [b[7] for b in builds]
        logger.info(
            f"Batched decode: {len(items)} instances, R_pad={r_pad}, DV={dv}"
        )
        decoded = _batched_decode_received(
            layouts, channels, msgs, self.max_iter, self.method
        )
        for i, (tid, dec, tr, checks, y, *_rest) in enumerate(builds):
            self._results[tid] = dec.stats_from_decoded(tr, decoded[i], checks, y)


class BatchedPaddedDecodeExecutor(BatchedDecodeExecutor):
    """Barrier batcher with PERSISTENT capacities: the padded check count
    and variable-degree cap only grow (doubling) across batched calls, so
    the whole multi-instance attack compiles the vmapped decode once per
    capacity level instead of once per 256-check bucket
    (BatchedDecodeExecutor).  Batched counterpart of PaddedCheckDecoder."""

    def __init__(self, num_instances, max_iter=100, method="product_sum",
                 r_cap=4096, dv_cap=16):
        super().__init__(num_instances, max_iter, method)
        self.r_cap = int(r_cap)
        self.dv_cap = int(dv_cap)

    def _target_shape(self, items):
        r = max(len(checks) for _tid, (_d, _t, checks, _y) in items)
        while r > self.r_cap:
            self.r_cap *= 2
        dv = max(dec.needed_dv() for _tid, (dec, _t, _c, _y) in items)
        while dv > self.dv_cap:
            self.dv_cap *= 2
        return self.r_cap, self.dv_cap


class BatchedCirculantDecodeExecutor(BatchedDecodeExecutor):
    """Barrier batcher over MaskedCirculantCheckDecoder instances: one
    vmapped full-circulant masked decode for all of them.

    Because the circulant shifts are DATA in _multi_circulant_bp, all
    instances (each with its own keys and random circulants) share one
    compiled (N, P_pad, W) program; instances with fewer plaintexts are
    padded with all-inert blocks."""

    def _execute(self, items):
        import jax
        import jax.numpy as jnp

        from ...ops.circulant_bp import _multi_circulant_bp

        p_pad = _shared_p_pad(items)
        builds = [
            (tid, dec, tr, checks, y, *dec.build_masked_arrays(checks, y, p_pad=p_pad))
            for tid, (dec, tr, checks, y) in items
        ]
        logger.info(
            f"Batched masked-circulant decode: {len(items)} instances, "
            f"P_pad={p_pad}"
        )
        # One async dispatch per instance: all instances share a single
        # compiled (N, P_pad, W) program (shifts are data), and the device
        # pipelines the dispatches.  A vmapped instance axis gives
        # bitwise-equal outputs, but its while_loop runs until ALL
        # instances converge, forfeiting per-instance early exit, and
        # shrinking live-instance counts would force recompiles.
        outs = [
            _multi_circulant_bp(
                jnp.asarray(pc[None]), jnp.asarray(pi[None]),
                jnp.asarray(sy[None]), jnp.asarray(sh),
                self.max_iter, self.method,
            )
            for (_tid, _dec, _tr, _checks, _y, pc, pi, sy, sh) in builds
        ]
        # ONE device->host transfer per class for the whole round instead of
        # one per instance.
        e_c_all = np.asarray(jnp.stack([o[0][0] for o in outs]))
        e_i_all = np.asarray(jnp.stack([o[1][0] for o in outs]))
        for i, (tid, dec, tr, checks, y, *_rest) in enumerate(builds):
            self._results[tid] = dec.stats_from_masked(
                tr, e_c_all[i], e_i_all[i], checks, y
            )


class ShardedCirculantDecodeExecutor(BatchedCirculantDecodeExecutor):
    """Mesh-sharded batched decode rounds: the batched attack's periodic
    masked-circulant decodes distributed over a ``jax.sharding.Mesh``
    (parallel.attack.make_sharded_masked_decode) instead of pipelined
    single-chip dispatches.

    The instance axis is padded (by repeating the last instance) to a
    multiple of the device count, sharded over every mesh axis, and
    decoded by ONE compiled program — the multi-chip scale-out story for
    the reference's only scale-out axis (run-parallel-hqc-simulation.sh's
    process-per-config sweep).

    ``crosscheck=True`` additionally decodes every instance through the
    production single-chip path (ops.circulant_bp._multi_circulant_bp,
    exactly what BatchedCirculantDecodeExecutor dispatches) and asserts
    the sharded error vectors are IDENTICAL — a sharded decode returning
    garbage cannot pass a round (used by __graft_entry__.dryrun_multichip).
    """

    def __init__(self, num_instances, mesh, max_iter=100,
                 method="product_sum", crosscheck=False):
        super().__init__(num_instances, max_iter, method)
        from ...parallel.attack import make_sharded_masked_decode

        self.mesh = mesh
        self.crosscheck = crosscheck
        self._sharded_decode = make_sharded_masked_decode(
            mesh, max_iter=max_iter, method=method
        )

    def _execute(self, items):
        import jax.numpy as jnp

        from ...ops.circulant_bp import _multi_circulant_bp

        p_pad = _shared_p_pad(items)
        builds = [
            (tid, dec, tr, checks, y,
             *dec.build_masked_arrays(checks, y, p_pad=p_pad))
            for tid, (dec, tr, checks, y) in items
        ]
        n_dev = self.mesh.devices.size
        pad = (-len(builds)) % n_dev
        logger.info(
            f"Sharded masked-circulant decode: {len(items)} instances "
            f"(+{pad} pad) over {n_dev} devices, P_pad={p_pad}"
        )
        stack = [np.stack([b[k] for b in builds] + [builds[-1][k]] * pad)
                 for k in (5, 6, 7, 8)]  # pc, pi, syn, shifts
        e_c, e_i, _conv = self._sharded_decode(
            *(jnp.asarray(a) for a in stack)
        )
        e_c = np.asarray(e_c)
        e_i = np.asarray(e_i)
        if self.crosscheck:
            for i, b in enumerate(builds):
                rc, ri, _cv, _it = _multi_circulant_bp(
                    jnp.asarray(b[5][None]), jnp.asarray(b[6][None]),
                    jnp.asarray(b[7][None]), jnp.asarray(b[8]),
                    self.max_iter, self.method,
                )
                assert (np.asarray(rc[0]) == e_c[i]).all() and (
                    np.asarray(ri[0]) == e_i[i]
                ).all(), (
                    f"sharded decode diverged from the single-chip path "
                    f"for instance {i}"
                )
        for i, (tid, dec, tr, checks, y, *_rest) in enumerate(builds):
            self._results[tid] = dec.stats_from_masked(
                tr, e_c[i], e_i[i], checks, y
            )


def simulate_hqc_attacks_batched(
    seeds,
    decode_every: int,
    weight: int,
    error_rate=0.0,
    param_set="128",
    max_oracle_calls=None,
    oracle_backend="fast",
    decode_backend="general",
    executor=None,
    checkpoint_dir=None,
    **attack_kwargs,
):
    """Run len(seeds) independent attack instances with batched decodes.

    Each instance attacks its own random key.  Returns a list of
    (success, tracking) in seed order.  ``decode_backend="circulant"``
    batches single-compile-shape masked full-circulant decodes; "padded"
    batches checks-only decodes at a persistent fixed capacity (one compile
    shape); "general" batches bucketed checks-only
    decodes.

    ``oracle_backend="timing"`` runs every instance against the MEASURED
    timing channel: instances profile/calibrate their own keys and their
    cycle-timed measurement blocks serialize on
    eval_oracle.MEASUREMENT_LOCK (timing is a host-global resource), while
    decode rounds still batch on device.  Extra ``attack_kwargs``
    (timing_measure, timing_profile_measurements, ...) forward to
    simulate_hqc_idealized_oracle.

    ``checkpoint_dir``: per-instance mid-attack checkpoints
    (``instance_<seed>.ckpt``) written at every clean point; on a relaunch
    each instance with an existing checkpoint resumes its exact state
    (key, rng stream, checks, channel tallies) while instances without one
    start fresh — so a killed multi-hour batched run continues instead of
    restarting (VERDICT round-4 #2; the round-3 82-minute batched death
    motivated this).
    """
    import os

    if executor is not None:
        pass  # caller-supplied (e.g. ShardedCirculantDecodeExecutor)
    elif decode_backend == "circulant":
        executor = BatchedCirculantDecodeExecutor(len(seeds))
    elif decode_backend == "padded":
        executor = BatchedPaddedDecodeExecutor(len(seeds))
    elif decode_backend == "general":
        executor = BatchedDecodeExecutor(len(seeds))
    else:
        raise ValueError(f"unknown decode_backend: {decode_backend}")
    results = [None] * len(seeds)
    params = make_params(param_set, decode_every, weight, error_rate)
    keypairs = [params.HQC.keypair() for _ in seeds]
    if checkpoint_dir:
        os.makedirs(checkpoint_dir, exist_ok=True)

    def run(i, seed):
        ckpt_path = (
            os.path.join(checkpoint_dir, f"instance_{seed}.ckpt")
            if checkpoint_dir else None
        )
        try:
            results[i] = simulate_hqc_idealized_oracle(
                make_random_state(seed),
                decode_every,
                weight,
                keyfile=None,
                error_rate=error_rate,
                param_set=param_set,
                max_oracle_calls=max_oracle_calls,
                oracle_backend=oracle_backend,
                decode_executor=executor,
                decode_backend=decode_backend,
                keypair=keypairs[i],
                checkpoint_path=ckpt_path,
                resume=bool(ckpt_path and os.path.exists(ckpt_path)),
                **attack_kwargs,
            )
            if ckpt_path and results[i][0] and os.path.exists(ckpt_path):
                os.remove(ckpt_path)  # a recovered key must not be resumed
        finally:
            executor.deregister()

    threads = [
        threading.Thread(target=run, args=(i, s), daemon=True)
        for i, s in enumerate(seeds)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    logger.info(f"Batched run: {executor.batched_calls} batched decode calls")
    return results, executor.batched_calls
