"""Pallas (Triton route) kernel: the fused decode logit tail.

Every beam step ends in ``logits = act @ ff_logit_W + b`` over the whole
vocabulary, a log-softmax and a per-row top-k.  Left to XLA that writes
the (rows, n_words) f32 logits to device memory and reads them back for
the logsumexp and again for the top-k: at beam 5 x batch 384 and the
MSVD vocabulary (1920 x 13056) about 100 MB per pass.  This kernel
computes the logits tile by tile in registers and reduces each tile at
once to (top-k values, top-k indices, running max, running sum-exp), so
the logits never reach device memory.

Layout (Hopper, Triton route): the grid is (row blocks, vocab splits),
all blocks independent.  Inside a block a loop walks the split's vocab
tiles and carries an online max / sum-exp and a sorted running top-k.
Each split writes its partial (top-k, max, sum-exp); a small XLA merge
(``_merge_splits``) takes the top-k of the union of the splits'
candidates and combines the logsumexp.  Ties resolve to the lowest
global index, as ``lax.top_k`` does: within a tile the first pass takes
the lowest index among equals, the running merge keeps earlier (lower
index) entries ahead of equal later ones, and splits are merged in
vocabulary order.

The kernel is compiled only for the GPU.  ``interpret=True`` (tests)
runs it in the Pallas interpreter; without it, lowering for any other
platform raises.  Which step function a decode uses is chosen by
``get_step_fn``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from . import step as step_mod

_NEG = -1e30          # padded vocab bias and "already taken" sentinel
_IDX_BIG = 2 ** 30    # plain int: jnp scalars would be captured consts


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _make_tail_kernel(k_sel: int, kp: int, tr: int, tv: int, tk: int,
                      dw: int, n_tiles: int, split_w: int):
    """One (row block i, vocab split j) program."""

    def kernel(x_ref, w_ref, b_ref, vals_ref, idx_ref, m_ref, s_ref):
        i = pl.program_id(0)
        j = pl.program_id(1)
        rows = pl.ds(i * tr, tr)
        col0 = j * split_w

        def tile(t, carry):
            m_old, s_old, bv, bi = carry
            c0 = col0 + t * tv
            logits = jnp.zeros((tr, tv), jnp.float32)
            for kc in range(dw // tk):
                logits += pl.dot(x_ref[rows, pl.ds(kc * tk, tk)],
                                 w_ref[pl.ds(kc * tk, tk), pl.ds(c0, tv)])
            logits += b_ref[pl.ds(c0, tv)][None, :]

            # online logsumexp
            m_new = jnp.maximum(m_old, jnp.max(logits, axis=1))
            s_new = (s_old * jnp.exp(m_old - m_new)
                     + jnp.sum(jnp.exp(logits - m_new[:, None]), axis=1))

            # k extraction passes over the tile, each candidate
            # insertion-merged into the sorted running top-k (a list of
            # k (tr,) vectors: Triton tensors need power-of-two shapes)
            cols = jax.lax.broadcasted_iota(jnp.int32, (tr, tv), 1) + c0
            lt = logits
            bv, bi = list(bv), list(bi)
            for _ in range(k_sel):
                v = jnp.max(lt, axis=1)
                iv = jnp.min(jnp.where(lt == v[:, None], cols, _IDX_BIG),
                             axis=1)
                lt = jnp.where(cols == iv[:, None], _NEG, lt)
                rank = sum((b >= v).astype(jnp.int32) for b in bv)
                nv, ni = [], []
                for p in range(k_sel):
                    keep, ins = rank > p, rank == p
                    pv = bv[p - 1] if p else v
                    pi = bi[p - 1] if p else iv
                    nv.append(jnp.where(keep, bv[p], jnp.where(ins, v, pv)))
                    ni.append(jnp.where(keep, bi[p], jnp.where(ins, iv, pi)))
                bv, bi = nv, ni
            return m_new, s_new, tuple(bv), tuple(bi)

        init = (jnp.full((tr,), _NEG, jnp.float32),
                jnp.zeros((tr,), jnp.float32),
                tuple(jnp.full((tr,), _NEG, jnp.float32)
                      for _ in range(k_sel)),
                tuple(jnp.zeros((tr,), jnp.int32) for _ in range(k_sel)))
        m, s, bv, bi = jax.lax.fori_loop(0, n_tiles, tile, init)

        # pack the k vectors into one power-of-two (tr, kp) tile
        kcol = jax.lax.broadcasted_iota(jnp.int32, (tr, kp), 1)
        vals = jnp.full((tr, kp), _NEG, jnp.float32)
        idx = jnp.zeros((tr, kp), jnp.int32)
        for p in range(k_sel):
            vals = jnp.where(kcol == p, bv[p][:, None], vals)
            idx = jnp.where(kcol == p, bi[p][:, None], idx)
        vals_ref[j, rows, :] = vals
        idx_ref[j, rows, :] = idx
        m_ref[j, rows] = m
        s_ref[j, rows] = s

    return kernel


def _merge_splits(vals, idx, m, s, k_sel: int):
    """Exact merge of per-split partials: the global top-k of a row lies
    in the union of its per-split top-k, and splits are concatenated in
    vocabulary order so ``lax.top_k``'s lowest-position tie-break is the
    lowest global index."""
    ns, rows, _ = vals.shape
    cand_v = vals[:, :, :k_sel].transpose(1, 0, 2).reshape(rows, ns * k_sel)
    cand_i = idx[:, :, :k_sel].transpose(1, 0, 2).reshape(rows, ns * k_sel)
    v2, pos = jax.lax.top_k(cand_v, k_sel)
    i2 = jnp.take_along_axis(cand_i, pos, axis=1)
    mg = jnp.max(m, axis=0)
    lse = mg + jnp.log(jnp.maximum(
        jnp.sum(s * jnp.exp(m - mg[None, :]), axis=0), 1e-38))
    return v2, i2, lse


@functools.partial(jax.jit, static_argnames=(
    "k_sel", "tr", "tv", "tk", "splits", "num_warps", "num_stages",
    "interpret"))
def _tail_call(x, w, b, k_sel: int, tr: int, tv: int, tk: int, splits: int,
               num_warps: int, num_stages: int, interpret: bool):
    rows, dw = x.shape
    vp = w.shape[1]
    rp = _round_up(rows, tr)
    if rp != rows:
        x = jnp.pad(x, ((0, rp - rows), (0, 0)))
    split_w = vp // splits
    kp = _pow2_at_least(k_sel)
    f32 = jnp.float32
    vals, idx, m, s = pl.pallas_call(
        _make_tail_kernel(k_sel, kp, tr, tv, tk, dw, split_w // tv, split_w),
        grid=(rp // tr, splits),
        out_shape=(jax.ShapeDtypeStruct((splits, rp, kp), f32),
                   jax.ShapeDtypeStruct((splits, rp, kp), jnp.int32),
                   jax.ShapeDtypeStruct((splits, rp), f32),
                   jax.ShapeDtypeStruct((splits, rp), f32)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=num_stages),
        cost_estimate=pl.CostEstimate(
            flops=2 * rp * dw * vp,
            bytes_accessed=((rp // tr) * dw * vp * w.dtype.itemsize
                            + splits * rp * dw * x.dtype.itemsize),
            transcendentals=rp * vp),
        interpret=interpret,
        name="stvd_logit_tail",
    )(x, w, b)
    v2, i2, lse = _merge_splits(vals, idx, m, s, k_sel)
    return v2[:rows], i2[:rows], lse[:rows]


# Tile shape of the tail (row block, vocab tile, contraction chunk, vocab
# splits, warps, pipeline stages); see PERF.md for how it was chosen.
TAIL_TILES = dict(tr=64, tv=64, tk=64, splits=16, num_warps=4,
                  num_stages=1)


def make_logit_tail(w, b, k_sel: int, interpret: bool = False,
                    **tiles):
    """Build the fused logit-tail closure: activation (rows, dw) ->
    (top-k raw logits, top-k indices, logsumexp per row); top-k
    log-probs are ``vals - lse[:, None]``.

    Called once per decode program (outside the while_loop) so the
    vocab-padding copy of W is loop-invariant.  Returns None when the
    shape does not suit the kernel (caller keeps the XLA path:
    materialized logits + ``lax.top_k``).  Greedy decoding (``k_sel ==
    1``) keeps the XLA path too: its log-softmax + argmax was measured
    faster end to end than the kernel (PERF.md).  ``tiles`` overrides
    entries of ``TAIL_TILES``.
    """
    t = dict(TAIL_TILES, **tiles)
    dw, v = w.shape
    if not 1 < k_sel <= 8 or dw % t["tk"] or v < t["splits"] * t["tv"]:
        return None
    vp = _round_up(v, t["splits"] * t["tv"])
    b = b.astype(jnp.float32)
    if vp != v:
        # padded columns: zero weights and a -1e30 bias never reach the
        # top-k and underflow to 0 inside the logsumexp
        w = jnp.pad(w, ((0, 0), (0, vp - v)))
        b = jnp.pad(b, (0, vp - v), constant_values=_NEG)

    def tail(logit_act):
        return _tail_call(logit_act.astype(w.dtype), w, b, k_sel,
                          interpret=interpret, **t)

    return tail


def make_tail_step(interpret: bool = False):
    """The decoder step (``step.step``, all XLA) carrying the fused logit
    tail; the decode loops pick the tail up off the step function."""
    def step_tail(params, cfg, state, sc, emb_t, x_pre=None):
        return step_mod.step(params, cfg, state, sc, emb_t, x_pre)

    step_tail.make_logit_tail = functools.partial(make_logit_tail,
                                                  interpret=interpret)
    return step_tail


step_tail = make_tail_step()


def get_step_fn(use_kernel=None):
    """Step-function selector.  ``None`` (the default everywhere) picks
    the fused logit tail on the GPU and the plain XLA step elsewhere;
    True asks for the compiled kernel (lowering it for anything but the
    GPU raises); False is the plain XLA step.

    Teacher-forced training with ``cfg.fused_seq_grad`` (the default)
    does not route through the returned step at all — the hand-derived
    sequence VJP (model/seqgrad.py) supersedes it there."""
    if use_kernel is None:
        use_kernel = jax.default_backend() == "gpu"
    return step_tail if use_kernel else step_mod.step
