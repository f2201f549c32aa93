"""Two-alphabet q-ary decoder for ``H = [H'|I]`` codes (Kyber pipeline).

Batched equivalent of the reference's Rust ``DecoderSpecial``
(decoder_special.rs:294-675): the first ``N-R`` columns are secret coefficients
in ``[-B..B]``; the last ``R`` columns are measured check sums in
``[-BSUM..BSUM]`` with ``BSUM = SW*B``.  Each check connects up to ``SW=DC-1``
B-variables and exactly one sum variable.

Design notes:
- The check update's full d-grid enumeration (``(2B+1)^SW`` configurations,
  SimpleDValueIterator, decoder_special.rs:226-275) becomes exact min-plus
  convolutions; irregular rows (the ``num_ignore`` pinned-zero rule,
  :247-263) are identity-delta padding.
- Sum variables have degree 1, so their v2c message is their channel prior,
  constant across iterations — computed once.
- The frame dimension is a leading batch axis.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..channels.llr import probs_to_llr
from . import minplus
from .minplus import BIG
from .qary import _signed


@partial(jax.jit, static_argnames=("max_iter", "b", "bsum", "sw", "early_exit"))
def _special_min_sum(
    bvar_idx,  # [R, SW] int32, pad == n_b
    bvar_sign,  # [R, SW] int8
    bvar_mask,  # [R, SW] bool
    var_flat,  # [N_b, DV] int32 into [R*SW+1]
    var_sign,  # [N_b, DV] int8
    var_mask,  # [N_b, DV] bool
    sum_sign,  # [R] int8 (sign of the identity entry, row-ordered)
    row_of_sum,  # [R] int32: row index serving sum-variable s
    channel,  # [Bt, N_b, BSIZE]
    channel_sum_row,  # [Bt, R, BSUMSIZE]  (already row-ordered)
    max_iter: int,
    b: int,
    bsum: int,
    sw: int,
    early_exit: bool = False,  # stop when every frame satisfies all checks
):
    bt, n_b, bsize = channel.shape
    r = bvar_idx.shape[0]
    bsumsize = 2 * bsum + 1
    s_mid = (2 * sw - 1) * b  # support of (SW-1) B-vars conv'd with the sum var

    delta = minplus.identity(bsize)[None, None, :]
    channel_pad = jnp.concatenate(
        [channel, jnp.broadcast_to(delta, (bt, 1, bsize))], axis=1
    )
    sign_c = jnp.asarray(bvar_sign, jnp.int32)
    sign_v = jnp.asarray(var_sign, jnp.int32)

    v2c0 = _signed(
        jnp.take(channel_pad, bvar_idx.reshape(-1), axis=1).reshape(bt, r, sw, bsize),
        sign_c,
    )
    v2c0 = jnp.where(bvar_mask[..., None], v2c0, delta[None])

    # Degree-1 sum variables: v2c == signed channel, forever.
    v2c_sum = _signed(channel_sum_row, jnp.asarray(sum_sign, jnp.int32))

    def body(_, state):
        v2c, _tb, _ts = state
        # --- check update.
        ext_b = minplus.chain_exclusive(v2c, s_mid, extra=v2c_sum, s_out=b)
        c2v_b = jnp.minimum(ext_b[..., ::-1], BIG)  # [Bt, R, SW, BSIZE]

        # Full conv of all SW B-messages has support exactly +-BSUM.
        full = minplus.identity(bsumsize, like=v2c[..., 0, :])
        for j in range(sw):
            full = minplus.conv(v2c[..., j, :], full, bsum)
        c2v_sum = jnp.minimum(full[..., ::-1], BIG)  # [Bt, R, BSUMSIZE]

        # --- B-variable update.
        c2v_flat = jnp.concatenate(
            [c2v_b.reshape(bt, r * sw, bsize), jnp.zeros((bt, 1, bsize))], axis=1
        )
        c2v_var = jnp.take(c2v_flat, var_flat.reshape(-1), axis=1).reshape(
            bt, n_b, -1, bsize
        )
        c2v_var_u = _signed(c2v_var, sign_v)
        c2v_var_u = jnp.where(var_mask[..., None], c2v_var_u, 0.0)
        total_b = channel + jnp.sum(c2v_var_u, axis=2)

        # Extrinsic computed check-side (signed(total) - c2v_b replaces the
        # flat scatter with a gather; bitwise-identical messages).
        total_pad = jnp.concatenate(
            [total_b, jnp.broadcast_to(delta, (bt, 1, bsize))], axis=1
        )
        gathered = jnp.take(total_pad, bvar_idx.reshape(-1), axis=1).reshape(
            bt, r, sw, bsize
        )
        prim = _signed(gathered, sign_c) - c2v_b
        prim = prim - jnp.min(prim, axis=-1, keepdims=True)
        prim = jnp.minimum(prim, BIG)
        v2c_new = jnp.where(bvar_mask[..., None], prim, delta[None])

        # --- sum-variable totals (no outgoing update needed).
        c2v_sum_u = _signed(c2v_sum, jnp.asarray(sum_sign, jnp.int32))
        total_sum = channel_sum_row + c2v_sum_u
        return v2c_new, total_b, total_sum

    state0 = (
        v2c0,
        jnp.zeros((bt, n_b, bsize)),
        jnp.zeros((bt, r, bsumsize)),
    )

    def decide(total_b, total_sum):
        hard_b = jnp.argmin(total_b, axis=-1).astype(jnp.int32) - b
        hard_sum_row = jnp.argmin(total_sum, axis=-1).astype(jnp.int32) - bsum
        hard_sum = jnp.take(hard_sum_row, row_of_sum, axis=1)
        return jnp.concatenate([hard_b, hard_sum], axis=1), hard_b, hard_sum_row

    if not early_exit:
        _, total_b, total_sum = jax.lax.fori_loop(0, max_iter, body, state0)
        return decide(total_b, total_sum)[0]

    # Early-exit variant (beyond the reference): latch per-frame decisions
    # when every row satisfies sum(signed b-symbols) + signed sum-symbol == 0
    # over the integers (the counterweight rule, decoder_special.rs:533-537).
    sign_s = jnp.asarray(sum_sign, jnp.int32)

    def satisfied(hard_b, hard_sum_row):
        hard_pad = jnp.concatenate([hard_b, jnp.zeros((bt, 1), jnp.int32)], axis=1)
        sym = jnp.take(hard_pad, bvar_idx.reshape(-1), axis=1).reshape(bt, r, sw)
        sym = jnp.where(bvar_mask, sym * sign_c, 0)
        row = jnp.sum(sym, axis=-1) + sign_s[None, :] * hard_sum_row
        return jnp.all(row == 0, axis=-1)

    def w_body(state):
        it, loop_state, hard_out, conv = state
        loop_state = body(it, loop_state)
        _, total_b, total_sum = loop_state
        hard, hard_b, hard_sum_row = decide(total_b, total_sum)
        ok = satisfied(hard_b, hard_sum_row)
        hard_out = jnp.where(conv[:, None], hard_out, hard)
        return it + 1, loop_state, hard_out, conv | ok

    def w_cond(state):
        it, _s, _h, conv = state
        return (it < max_iter) & ~jnp.all(conv)

    state = (jnp.int32(0), state0, jnp.zeros((bt, n_b + r), jnp.int32),
             jnp.zeros((bt,), bool))
    _, _, hard, _ = jax.lax.while_loop(w_cond, w_body, state)
    return hard


class QarySpecialDecoder:
    """Decoder for ``[H'|I]`` with per-class alphabets B (secrets) and BSUM
    (measured sums).  Construction mirrors pydecoder.rs:84-117:
    ``QarySpecialDecoder(H, B, BSUM, iterations)``.
    """

    def __init__(self, H, b: int, bsum: int, max_iter: int, sw=None,
                 early_exit=False):
        H = np.asarray(H)
        r, n = H.shape
        n_b = n - r
        if bsum % b != 0:
            raise ValueError(f"BSUM ({bsum}) must be a multiple of B ({b})")
        self.b, self.bsum, self.max_iter = int(b), int(bsum), int(max_iter)
        self.early_exit = bool(early_exit)
        self.n, self.r, self.n_b = n, r, n_b

        rows, cols = np.nonzero(H)
        is_sum = cols >= n_b
        deg_b = np.bincount(rows[~is_sum], minlength=r)
        sw = int(sw if sw is not None else max(1, deg_b.max()))
        self.sw = sw
        if self.bsum != self.sw * self.b:
            raise ValueError(f"BSUM ({bsum}) must equal SW ({sw}) * B ({b})")
        if np.bincount(rows[is_sum], minlength=r).max() != 1 or is_sum.sum() != r:
            raise ValueError("each row must contain exactly one sum-variable entry")
        if np.bincount(cols[is_sum] - n_b, minlength=r).max() != 1:
            raise ValueError("each sum variable must appear in exactly one row")

        bvar_idx = np.full((r, sw), n_b, np.int32)
        bvar_sign = np.ones((r, sw), np.int8)
        bvar_mask = np.zeros((r, sw), bool)
        sum_sign = np.ones(r, np.int8)
        sum_var = np.zeros(r, np.int32)
        dv = int(np.bincount(cols[~is_sum], minlength=n_b)[:n_b].max()) if (~is_sum).any() else 1
        var_flat = np.full((n_b, dv), r * sw, np.int32)
        var_sign = np.ones((n_b, dv), np.int8)
        var_mask = np.zeros((n_b, dv), bool)

        slot_c = np.zeros(r, np.int32)
        slot_v = np.zeros(n_b, np.int32)
        for i, j in zip(rows, cols):
            s = np.int8(H[i, j])
            if j >= n_b:
                sum_sign[i] = s
                sum_var[i] = j - n_b
            else:
                sc = slot_c[i]
                bvar_idx[i, sc] = j
                bvar_sign[i, sc] = s
                bvar_mask[i, sc] = True
                sv = slot_v[j]
                var_flat[j, sv] = i * sw + sc
                var_sign[j, sv] = s
                var_mask[j, sv] = True
                slot_c[i] = sc + 1
                slot_v[j] = sv + 1

        row_of_sum = np.zeros(r, np.int32)
        row_of_sum[sum_var] = np.arange(r, dtype=np.int32)
        self._sum_var = sum_var

        self._args = (
            jnp.asarray(bvar_idx),
            jnp.asarray(bvar_sign),
            jnp.asarray(bvar_mask),
            jnp.asarray(var_flat),
            jnp.asarray(var_sign),
            jnp.asarray(var_mask),
            jnp.asarray(sum_sign),
            jnp.asarray(row_of_sum),
        )

    def min_sum(self, channel_probs, channel_probs_sum):
        """``channel_probs``: [N-R, 2B+1] (or batched); ``channel_probs_sum``:
        [R, 2BSUM+1] (or batched) — probabilities, converted to LLR internally
        (pydecoder.rs:125-145)."""
        return self.min_sum_llr(
            probs_to_llr(jnp.asarray(channel_probs, jnp.float32)),
            probs_to_llr(jnp.asarray(channel_probs_sum, jnp.float32)),
        )

    def min_sum_llr(self, channel_llr, channel_llr_sum):
        """Decode precomputed min-sum LLRs (inf allowed; clipped internally),
        shaped like :meth:`min_sum`'s probabilities."""
        llr_b = jnp.asarray(channel_llr, jnp.float32)
        llr_s = jnp.asarray(channel_llr_sum, jnp.float32)
        squeeze = llr_b.ndim == 2
        if squeeze:
            llr_b, llr_s = llr_b[None], llr_s[None]
        llr_b = minplus.clip_inf(llr_b)
        llr_s = minplus.clip_inf(llr_s)
        # Order sum-variable channels by serving row.
        llr_s_row = jnp.take(llr_s, jnp.asarray(self._sum_var), axis=1)
        hard = _special_min_sum(
            *self._args, llr_b, llr_s_row, self.max_iter, self.b, self.bsum,
            self.sw, early_exit=self.early_exit,
        )
        return hard[0] if squeeze else hard
