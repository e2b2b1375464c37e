"""Parameter init, input fusion, and the scan-unrolled training forward.

Reference: ``model_attention.py:§init_params`` (weight creation) and
``§build_model`` (teacher-forced training graph) — SURVEY.md §2/§3.2.

Departures:
  * the time loop is ``lax.scan`` over a step function (shared verbatim
    with decoding — BASELINE requirement), not theano.scan,
  * with pure teacher forcing the vocab projection runs ONCE over the
    whole (T, B) block after the scan (one large MXU matmul) instead of
    per-step,
  * scheduled sampling (absent in the reference, mandated by BASELINE's
    north star) runs per-step logits inside the scan with per-step RNG.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..config import ModelConfig
from . import step as step_mod
from .step import (Params, StepOut, StepState, init_state,
                   logits_from_states, precompute)

# (params, cfg, state, step_context, emb_t, x_pre=None) -> StepOut
StepFn = Callable[..., StepOut]


# ---------------------------------------------------------------------------
# Initialization (reference common.py: norm_weight / ortho_weight)
# ---------------------------------------------------------------------------

def _norm(rng, shape, scale=0.01, dtype=jnp.float32):
    return scale * jax.random.normal(rng, shape, dtype)


def _ortho_stack(rng, nin, nout_blocks, dtype=jnp.float32):
    """Stacked orthogonal init for LSTM recurrent weights: (nin, nin*k)
    built from k independent orthogonal (nin, nin) blocks (reference
    ``ortho_weight`` usage for U)."""
    rngs = jax.random.split(rng, nout_blocks)
    blocks = [jax.nn.initializers.orthogonal()(r, (nin, nin), dtype)
              for r in rngs]
    return jnp.concatenate(blocks, axis=1)


def init_params(rng: jax.Array, cfg: ModelConfig) -> Params:
    """Create the full parameter pytree (flat dict; names echo the
    reference's param dict for auditability — SURVEY.md §2 'Model
    parameters inventory')."""
    ks = iter(jax.random.split(rng, 32))
    d, dw, dc, da = cfg.dim, cfg.dim_word, cfg.ctx_dim, cfg.attn_dim
    p: Params = {}
    p["Wemb"] = _norm(next(ks), (cfg.n_words, dw))
    # input fusion (MSR-VTT dual stream; appearance dim == ctx_dim).
    # Fan-in scaling, not the 0.01 norm init: the fused context feeds
    # everything downstream (attention scores, h0/c0), and a near-zero
    # tanh output stalls training (observed on the motion quality test).
    if cfg.use_motion:
        p["W_app"] = _norm(next(ks), (dc, dc), scale=1.0 / (dc ** 0.5))
        p["W_mot"] = _norm(next(ks), (cfg.motion_dim, dc),
                           scale=1.0 / (cfg.motion_dim ** 0.5))
        p["b_fuse"] = jnp.zeros((dc,))
    # init-state MLPs
    p["ff_state_W"] = _norm(next(ks), (dc, d))
    p["ff_state_b"] = jnp.zeros((d,))
    p["ff_memory_W"] = _norm(next(ks), (dc, d))
    p["ff_memory_b"] = jnp.zeros((d,))
    # LSTM
    p["W"] = _norm(next(ks), (dw, 4 * d))
    p["b"] = jnp.zeros((4 * d,))
    p["U"] = _ortho_stack(next(ks), d, 4)
    p["Wc"] = _norm(next(ks), (dc, 4 * d))
    # temporal attention
    p["Wc_att"] = _norm(next(ks), (dc, da))
    p["b_att"] = jnp.zeros((da,))
    p["Wd_att"] = _norm(next(ks), (d, da))
    p["U_att"] = _norm(next(ks), (da,))
    p["c_att"] = jnp.zeros(())
    # selector
    p["W_sel"] = _norm(next(ks), (d,))
    p["b_sel"] = jnp.zeros(())
    # spatial attention (tuyunbin addition)
    if cfg.use_spatial:
        dr = cfg.region_dim
        sa = dr  # spatial-attention projection width mirrors temporal
        p["Ws_att"] = _norm(next(ks), (dr, sa))
        p["bs_att"] = jnp.zeros((sa,))
        p["Wsd_att"] = _norm(next(ks), (d, sa))
        p["Us_att"] = _norm(next(ks), (sa,))
        p["cs_att"] = jnp.zeros(())
        p["W_spat_fuse"] = _norm(next(ks), (dr, dc))
    # frame-level LSTM encoder (reference option encoder='lstm'; the
    # default 'none' matches the reference default)
    if cfg.encoder == "lstm":
        p["enc_W"] = _norm(next(ks), (dc, 4 * dc))
        p["enc_U"] = _ortho_stack(next(ks), dc, 4)
        p["enc_b"] = jnp.zeros((4 * dc,))
    # logit stack
    p["ff_logit_lstm_W"] = _norm(next(ks), (d, dw))
    p["ff_logit_lstm_b"] = jnp.zeros((dw,))
    p["ff_logit_ctx_W"] = _norm(next(ks), (dc, dw))
    p["ff_logit_W"] = _norm(next(ks), (dw, cfg.n_words))
    p["ff_logit_b"] = jnp.zeros((cfg.n_words,))
    return p


def param_count(params: Params) -> int:
    return sum(int(x.size) for x in jax.tree_util.tree_leaves(params))


# ---------------------------------------------------------------------------
# Input fusion
# ---------------------------------------------------------------------------

def encode_context(params: Params, cfg: ModelConfig, frames: jax.Array,
                   motion: Optional[jax.Array] = None) -> jax.Array:
    """Fuse input feature streams to the (B, K, ctx_dim) context.

    Single stream (MSVD): identity — frames ARE the context (reference
    encoder='none').  Dual stream (MSR-VTT config 4): learned LINEAR
    fusion of appearance + motion — the reference concatenates
    pre-extracted ResNet+C3D features offline (a linear map); a tanh
    here saturates on real-scale features and stalls training
    (observed: nll plateau on the motion quality test).
    """
    cdtype = jnp.dtype(cfg.compute_dtype)
    if not cfg.use_motion:
        ctx = frames
    else:
        if motion is None:
            raise ValueError("use_motion=True but no motion features given")
        ctx = (step_mod._dot(frames, params["W_app"], cdtype)
               + step_mod._dot(motion, params["W_mot"], cdtype)
               + params["b_fuse"])
    if cfg.encoder == "lstm":
        ctx = ctx + _frame_lstm(params, cfg, ctx)   # residual (masked
        # frames are excluded downstream by the temporal-attention mask)
    return ctx


def _frame_lstm(params: Params, cfg: ModelConfig, ctx: jax.Array
                ) -> jax.Array:
    """Frame-level LSTM over the K frames (reference encoder='lstm').

    The input projection for all K frames runs as one MXU matmul
    outside the scan; only the recurrence is sequential.
    """
    cdtype = jnp.dtype(cfg.compute_dtype)
    dc = cfg.ctx_dim
    B = ctx.shape[0]
    x_pre = step_mod._dot(ctx, params["enc_W"], cdtype) + params["enc_b"]

    def body(carry, x_t):
        h, c = carry
        preact = x_t + step_mod._dot(h, params["enc_U"], cdtype)
        i = jax.nn.sigmoid(preact[:, 0 * dc: 1 * dc])
        f = jax.nn.sigmoid(preact[:, 1 * dc: 2 * dc])
        o = jax.nn.sigmoid(preact[:, 2 * dc: 3 * dc])
        g = jnp.tanh(preact[:, 3 * dc: 4 * dc])
        c_t = f * c + i * g
        h_t = o * jnp.tanh(c_t)
        return (h_t, c_t), h_t

    init = (jnp.zeros((B, dc)), jnp.zeros((B, dc)))
    _, hs = jax.lax.scan(body, init, jnp.swapaxes(x_pre, 0, 1))
    return jnp.swapaxes(hs, 0, 1)                    # (B, K, dc)


# ---------------------------------------------------------------------------
# Training forward (teacher forcing / scheduled sampling)
# ---------------------------------------------------------------------------

class ForwardOut(NamedTuple):
    logits: jax.Array        # (B, T, n_words)
    alphas: jax.Array        # (B, T, K) temporal attention maps
    nll_per_example: jax.Array  # (B,)


def forward_train(
    params: Params,
    cfg: ModelConfig,
    batch: Dict[str, jax.Array],
    rng: Optional[jax.Array] = None,
    train: bool = True,
    ss_prob: float = 0.0,
    step_fn: Optional[StepFn] = None,
) -> ForwardOut:
    """Teacher-forced forward over a batch.

    ``batch`` keys: frames (B,K,D), frame_mask (B,K), tokens (B,T),
    token_mask (B,T), optionally regions (B,K,R,Dr), motion (B,K,Dm).

    Precedence note: with ``cfg.fused_seq_grad`` (the default) and pure
    teacher forcing, the scan runs the hand-derived sequence VJP
    (model/seqgrad.py), which has its own inlined step body — a caller-
    supplied ``step_fn`` is intentionally NOT consulted on that path
    (its fused logit tail serves decoding only); the hand VJP is
    parity-pinned against autodiff of the step.  ``step_fn`` governs
    scheduled sampling,
    spatial-without-fused-VJP, eval, and all decode paths.
    """
    step_fn = step_fn or step_mod.step
    if cfg.decode_quant != "none":
        # decode_quant is a SERVING knob only: the quantization round/
        # clip ops have zero gradient a.e., so letting it reach the
        # scheduled-sampling scan (which runs the fused-gates step)
        # would silently kill dL/d{W,U,Wc}.  Training always runs the
        # full-precision gates.
        import dataclasses
        cfg = dataclasses.replace(cfg, decode_quant="none")
    params = step_mod.cast_params(params, cfg)  # one weight cast, not T
    tokens = batch["tokens"]
    B, T = tokens.shape
    if rng is None:
        rng = jax.random.PRNGKey(0)
    rng_drop, rng_ss = jax.random.split(rng)

    ctx = encode_context(params, cfg, batch["frames"], batch.get("motion"))
    sc = precompute(params, cfg, ctx, batch["frame_mask"],
                    batch.get("regions"))
    state0 = init_state(params, cfg, sc)

    emb_all = params["Wemb"][tokens]                      # (B, T, dw)
    # teacher inputs: step t sees gold word t-1 (zeros at t=0 — the
    # reference shifts emb one step right with a zero first row)
    emb_in = jnp.concatenate(
        [jnp.zeros_like(emb_all[:, :1]), emb_all[:, :-1]], axis=1)

    if ss_prob == 0.0:
        # ---- fast path: pure teacher forcing -------------------------
        # input projection for ALL steps in one MXU matmul (the
        # reference recomputes W @ emb inside theano.scan every step)
        cdtype = jnp.dtype(cfg.compute_dtype)
        x_pre_all = step_mod._dot(emb_in, params["W"], cdtype) + params["b"]

        if cfg.fused_seq_grad:
            # hand-derived sequence VJP: wgrads as post-scan GEMMs
            # instead of autodiff's per-step 220-360 MB fp32 accumulators
            # (model/seqgrad.py; parity pinned in tests/test_seqgrad.py).
            # The spatial path (config 2) has its own derivation that
            # kills autodiff's pregion/regions cotangent carries.
            from . import seqgrad
            run = seqgrad.run_spatial if cfg.use_spatial else seqgrad.run
            hs, ctxs, alphas = run(
                params, cfg, sc, state0, jnp.swapaxes(x_pre_all, 0, 1))
            hs = jnp.swapaxes(hs, 0, 1)
            ctxs = jnp.swapaxes(ctxs, 0, 1)
            alphas = jnp.swapaxes(alphas, 0, 1)
            logits = logits_from_states(params, cfg, hs, ctxs, emb_in,
                                        dropout_rng=rng_drop, train=train)
            nll = sequence_nll(logits, tokens, batch["token_mask"])
            return ForwardOut(logits=logits, alphas=alphas,
                              nll_per_example=nll)

        def body(state, xs):
            emb_t, x_pre_t = xs
            out = step_fn(params, cfg, state, sc, emb_t, x_pre_t)
            return StepState(out.h, out.c), (out.h, out.ctx_t, out.alpha)

        if cfg.remat and train:
            # save only the scan carries/outputs; the per-step attention
            # intermediates (spatial e is (B,K,R,s) — the framework's
            # largest activation) are recomputed in the backward
            body = jax.checkpoint(body)
        _, (hs, ctxs, alphas) = jax.lax.scan(
            body, state0,
            (jnp.swapaxes(emb_in, 0, 1), jnp.swapaxes(x_pre_all, 0, 1)),
            unroll=cfg.scan_unroll)
        hs = jnp.swapaxes(hs, 0, 1)          # (B, T, dim)
        ctxs = jnp.swapaxes(ctxs, 0, 1)      # (B, T, ctx_dim)
        alphas = jnp.swapaxes(alphas, 0, 1)  # (B, T, K)
        logits = logits_from_states(params, cfg, hs, ctxs, emb_in,
                                    dropout_rng=rng_drop, train=train)
    else:
        # ---- scheduled sampling: per-step logits + sampled inputs ----
        drop_rngs = jax.random.split(rng_drop, T)
        ss_rngs = jax.random.split(rng_ss, T)

        def body(carry, xs):
            state, prev_pred = carry
            t, emb_gold_t, drop_rng, ss_rng = xs
            # t=0 always takes the gold (zero) embedding: there is no
            # previous prediction yet, and both the teacher-forced path
            # and the decoders feed zeros at the first step — feeding
            # Wemb[0] (EOS) here would make the t=0 input convention
            # inconsistent whenever ss_prob > 0.
            use_model = jax.random.bernoulli(ss_rng, ss_prob, (B,)) & (t > 0)
            emb_model = params["Wemb"][prev_pred]
            emb_t = jnp.where(use_model[:, None], emb_model, emb_gold_t)
            out = step_fn(params, cfg, state, sc, emb_t)
            logit_t = logits_from_states(params, cfg, out.h, out.ctx_t,
                                         emb_t, dropout_rng=drop_rng,
                                         train=train)
            pred = jnp.argmax(logit_t, axis=-1).astype(jnp.int32)
            return (StepState(out.h, out.c), pred), (logit_t, out.alpha)

        if cfg.remat and train:
            body = jax.checkpoint(body)
        init = (state0, jnp.zeros((B,), jnp.int32))
        _, (logits, alphas) = jax.lax.scan(
            body, init,
            (jnp.arange(T), jnp.swapaxes(emb_in, 0, 1), drop_rngs, ss_rngs))
        logits = jnp.swapaxes(logits, 0, 1)
        alphas = jnp.swapaxes(alphas, 0, 1)

    nll = sequence_nll(logits, tokens, batch["token_mask"])
    return ForwardOut(logits=logits, alphas=alphas, nll_per_example=nll)


def sequence_nll(logits: jax.Array, tokens: jax.Array, mask: jax.Array
                 ) -> jax.Array:
    """Per-example summed negative log-likelihood (reference cost:
    ``-sum_t mask * log p(x_t)``)."""
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    gold = jnp.take_along_axis(logp, tokens[..., None].astype(jnp.int32),
                               axis=-1)[..., 0]
    return -jnp.sum(gold * mask, axis=-1)
