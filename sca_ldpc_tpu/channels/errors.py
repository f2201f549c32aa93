"""Measurement-channel error models.

Reference semantics (simulate/decode.py:9-127 ``ErrorsProvider``): a uniform
binary-symmetric rate, or a file of per-position distributions — one line per
position, each line either a single probability (binary) or an odd number of
probabilities over symbols ``[-n//2 .. n//2]`` (q-ary).  Position indices wrap
modulo the file length.

Two sampling paths:

- :meth:`get_error` — scalar host path with the reference's exact RNG draw
  sequence (one ``rng.rand()`` per position), for conformance tests.
- :meth:`sample_batch` — the device path: one ``jax.random`` categorical draw for
  a whole ``[batch, n]`` error tensor.  This is the reference's per-position
  Python loop (decode.py:166-167) collapsed into a single device op.
"""

import re

import numpy as np


class ErrorsProvider:
    def __init__(self, error_rate, error_file, rng):
        self.error_rate = error_rate
        self.rng = rng
        self.error_distribution = None
        if error_file is not None:
            rows = []
            with open(error_file, "rt") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    rows.append([float(x) for x in re.split("[, ]+", line)])
            self.error_distribution = rows

    # -- host path (reference-exact RNG stream) ------------------------------

    def __get_binary_error(self, threshold):
        return 1 if self.rng.rand() < threshold else 0

    def get_error(self, pos):
        """Sample one error symbol for position ``pos`` (wraps modulo file length)."""
        if self.error_distribution is None:
            return self.__get_binary_error(self.error_rate)
        pr = self.error_distribution[pos % len(self.error_distribution)]
        if len(pr) == 1:
            return self.__get_binary_error(pr[0])
        rand = self.rng.rand()
        res = -(len(pr) // 2)
        threshold = 0.0
        for p in pr:
            threshold += p
            if threshold > rand:
                return res
            res += 1
        return res - 1  # numerical fall-through (probs summing <1): last symbol

    def get_error_rate(self):
        return self.error_rate if self.error_distribution is None else None

    def get_binary_channel_probs(self, n=None):
        """Per-position error probabilities, cycled to length ``n``.

        Returns ``[None]`` when running in uniform-rate mode (matching
        decode.py:110-127).
        """
        if self.error_distribution is None:
            return [None]
        if len(self.error_distribution[0]) != 1:
            raise ValueError("Distribution from the file isn't binary")
        flat = [row[0] for row in self.error_distribution]
        if n is None:
            return flat
        reps = -(-n // len(flat))
        return (flat * reps)[:n]

    # -- device path ---------------------------------------------------------

    def is_qary(self):
        return self.error_distribution is not None and len(self.error_distribution[0]) > 1

    def num_symbols(self):
        return len(self.error_distribution[0]) if self.is_qary() else 2

    def position_probs(self, n):
        """``[n, num_symbols]`` probability table (cycled), as float32.

        Binary mode: columns are ``[P(0), P(1)]``.  Q-ary mode: columns are the
        symbol probabilities for ``[-s//2 .. s//2]``.
        """
        if self.error_distribution is None:
            p = float(self.error_rate)
            return np.tile(np.array([[1.0 - p, p]], dtype=np.float32), (n, 1))
        rows = self.error_distribution
        table = []
        for i in range(n):
            pr = rows[i % len(rows)]
            if len(pr) == 1:
                table.append([1.0 - pr[0], pr[0]])
            else:
                table.append(pr)
        return np.asarray(table, dtype=np.float32)

    def sample_batch(self, key, batch, n):
        """Sample ``[batch, n]`` error symbols on device.

        Binary mode returns values in {0, 1}; q-ary mode returns values in
        ``[-s//2 .. s//2]``.
        """
        import jax
        import jax.numpy as jnp

        table = jnp.asarray(self.position_probs(n))
        logits = jnp.log(jnp.maximum(table, 1e-30))
        draws = jax.random.categorical(key, logits[None, :, :], axis=-1, shape=(batch, n))
        if self.is_qary():
            return draws - (self.num_symbols() // 2)
        return draws
