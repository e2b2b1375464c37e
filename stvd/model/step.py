"""The fused spatial-temporal attention + LSTM decoder step (pure jnp).

This is the semantic heart of the model (reference:
``model_attention.py:§lstm_cond_layer`` — SURVEY.md §3.2).  One step:

    [spatial]  score R regions/frame vs h_{t-1} -> softmax_R -> attended
               region vec per frame, fused into the frame feature
    [temporal] score K frames vs h_{t-1} -> masked softmax_K -> context
    [selector] beta = sigmoid(W_sel h) scales the context
    [LSTM]     gates from (prev word emb, h_{t-1}, context)

Departures from the reference:
  * all h-dependent projections are issued as ONE fused matmul
    (weights concatenated at trace time),
  * the h-independent projections of the frame/region banks are
    precomputed once OUTSIDE the scan (``precompute``) instead of being
    recomputed per step inside theano.scan,
  * static shapes + masks everywhere (no ragged batches).
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..config import ModelConfig

Params = Dict[str, jax.Array]

_NEG_INF = -1e30


def masked_softmax(e: jax.Array, mask: Optional[jax.Array], axis: int = -1
                   ) -> jax.Array:
    """Numerically safe masked softmax.

    Fully-masked rows return all-zeros (not NaN) — the edge case called
    out in SURVEY.md §4 (padded videos with zero valid frames).
    """
    if mask is not None:
        e = jnp.where(mask > 0, e, _NEG_INF)
    m = jnp.max(e, axis=axis, keepdims=True)
    ex = jnp.exp(e - jax.lax.stop_gradient(m))
    if mask is not None:
        ex = ex * (mask > 0)
    denom = jnp.sum(ex, axis=axis, keepdims=True)
    return ex / jnp.maximum(denom, 1e-20)


class StepState(NamedTuple):
    h: jax.Array        # (B, dim)
    c: jax.Array        # (B, dim)


class StepContext(NamedTuple):
    """Per-sequence tensors that are constant across decode steps.

    Built once by ``precompute`` (outside scan) — the reference recomputes
    ``Wc_att @ ctx`` every timestep inside theano.scan.
    """

    ctx: jax.Array              # (B, K, ctx_dim) fused frame features
    pctx: jax.Array             # (B, K, attn_dim) ctx @ Wc_att + b_att
    ctx_mask: jax.Array         # (B, K)
    mean_ctx: jax.Array         # (B, ctx_dim) masked mean (for h0/c0)
    regions: Optional[jax.Array] = None    # (B, K, R, Dr)
    pregion: Optional[jax.Array] = None    # (B, K, R, s_attn)
    w_sf_att: Optional[jax.Array] = None   # (Dr, attn_dim) = W_spat_fuse @ Wc_att
    h_proj_w: Optional[jax.Array] = None   # (dim, 4d+attn+1[+s]) fused h weights
    h_att_w: Optional[jax.Array] = None    # (dim, attn+1[+s]) h weights sans U
    gates_w: Optional[jax.Array] = None    # (dw+dim+ctx, 4d) = [W; U; Wc]
    gates_w_q: Optional[jax.Array] = None  # int8 gates stack (decode_quant)
    gates_scale: Optional[jax.Array] = None  # (4d,) per-column dequant scale


class StepOut(NamedTuple):
    h: jax.Array            # (B, dim)
    c: jax.Array            # (B, dim)
    ctx_t: jax.Array        # (B, ctx_dim) attended (+gated) context
    alpha: jax.Array        # (B, K) temporal attention weights
    alpha_s: Optional[jax.Array]  # (B, K, R) spatial weights (None w/o spatial)


def _dot(a: jax.Array, b: jax.Array, cdtype) -> jax.Array:
    """Matmul in compute dtype with fp32 accumulation.

    ``astype`` is a no-op when the operand is already in compute dtype —
    ``cast_params`` pre-casts weight matrices once per forward so the
    scan body never re-reads fp32 weights (no reliance on XLA LICM).
    """
    return jnp.dot(a.astype(cdtype), b.astype(cdtype),
                   preferred_element_type=jnp.float32)


@functools.partial(jax.custom_vjp, nondiff_argnums=(2,))
def _dot_bf16_wgrad(a: jax.Array, w: jax.Array, cdtype_name: str
                    ) -> jax.Array:
    """``_dot`` whose weight cotangent is emitted in the weight's own
    (compute) dtype instead of fp32.

    JAX's scan transpose accumulates cotangents of loop-invariant bf16
    weights in an fp32 carry; for the (dim, 4*dim+attn+1) gates stack
    that carry is 220 MB read+written EVERY backward scan step.
    Returning the per-step contribution as bf16 halves that
    accumulator traffic.  Opt-in via
    ``ModelConfig.wgrad_dtype='bfloat16'`` — bf16 accumulation over the
    ~30 scan steps costs gradient precision (tested bound ~1e-2
    relative), which adadelta's per-coordinate normalization tolerates.
    """
    cdtype = jnp.dtype(cdtype_name)
    return jnp.dot(a.astype(cdtype), w.astype(cdtype),
                   preferred_element_type=jnp.float32)


def _dot_bf16_wgrad_fwd(a, w, cdtype_name):
    return _dot_bf16_wgrad(a, w, cdtype_name), (a, w)


def _dot_bf16_wgrad_bwd(cdtype_name, res, g):
    a, w = res
    cdtype = jnp.dtype(cdtype_name)
    gc = g.astype(cdtype)
    da = jnp.dot(gc, w.astype(cdtype).T,
                 preferred_element_type=jnp.float32).astype(a.dtype)
    dw = jnp.dot(a.astype(cdtype).T, gc,
                 preferred_element_type=jnp.float32).astype(w.dtype)
    return da, dw


_dot_bf16_wgrad.defvjp(_dot_bf16_wgrad_fwd, _dot_bf16_wgrad_bwd)


def _w_dot(a: jax.Array, w: jax.Array, cfg: ModelConfig) -> jax.Array:
    """Weight matmul on the train-scan hot path: picks the wgrad-
    accumulation flavor from ``cfg.wgrad_dtype``."""
    if cfg.wgrad_dtype == "bfloat16" and cfg.compute_dtype != "float32":
        return _dot_bf16_wgrad(a, w, cfg.compute_dtype)
    return _dot(a, w, jnp.dtype(cfg.compute_dtype))


def cast_params(params: Params, cfg: ModelConfig) -> Params:
    """Pre-cast weight matrices (ndim >= 2) to the compute dtype ONCE.

    Biases/vectors/scalars stay fp32 (they add into fp32 accumulators).
    Differentiable: gradients flow through the cast back to the fp32
    master parameters (standard mixed precision).
    """
    cdtype = jnp.dtype(cfg.compute_dtype)
    if cdtype == jnp.float32:
        return params
    return {k: (v.astype(cdtype) if v.ndim >= 2 else v)
            for k, v in params.items()}


def precompute(params: Params, cfg: ModelConfig, ctx: jax.Array,
               ctx_mask: jax.Array, regions: Optional[jax.Array] = None
               ) -> StepContext:
    """Hoist all h-independent work out of the decode loop.

    ``ctx`` is the (B, K, ctx_dim) fused frame features (see
    ``decoder.encode_context`` for the input fusion).
    """
    cdtype = jnp.dtype(cfg.compute_dtype)
    # pctx stays fp32: the attention's tanh input keeps full precision
    pctx = _dot(ctx, params["Wc_att"], cdtype) + params["b_att"]
    denom = jnp.maximum(jnp.sum(ctx_mask, axis=1, keepdims=True), 1.0)
    mean_ctx = jnp.sum(ctx * ctx_mask[..., None], axis=1) / denom
    pregion = None
    w_sf_att = None
    if cfg.use_spatial:
        if regions is None:
            raise ValueError("use_spatial=True but no region features given")
        pregion = _dot(regions, params["Ws_att"], cdtype) + params["bs_att"]
        # Composition of (spatial-fusion -> temporal-attention-projection):
        # pctx'_t = pctx + spat_t @ (W_spat_fuse @ Wc_att).  Precomputing the
        # composed (Dr, attn_dim) weight saves one per-step matmul.
        w_sf_att = _dot(params["W_spat_fuse"], params["Wc_att"], cdtype)
    gates_w = _gates_weights(params)
    gates_w_q = gates_scale = None
    if cfg.decode_quant == "int8":
        # per-output-column symmetric weight quantization, done ONCE per
        # decode program (precompute runs outside the while_loop); int8
        # tensor cores run the gates matmul at twice the bf16 rate
        w32 = gates_w.astype(jnp.float32)
        gates_scale = jnp.maximum(jnp.max(jnp.abs(w32), axis=0),
                                  1e-8) / 127.0
        gates_w_q = jnp.clip(jnp.round(w32 / gates_scale[None, :]),
                             -127, 127).astype(jnp.int8)
    return StepContext(ctx=ctx, pctx=pctx, ctx_mask=ctx_mask,
                       mean_ctx=mean_ctx, regions=regions, pregion=pregion,
                       w_sf_att=w_sf_att,
                       h_proj_w=_h_projection_weights(params, cfg),
                       h_att_w=_h_att_weights(params, cfg),
                       gates_w=gates_w, gates_w_q=gates_w_q,
                       gates_scale=gates_scale)


def init_state(params: Params, cfg: ModelConfig, sc: StepContext) -> StepState:
    """h0/c0 from the masked mean context via tanh MLPs (reference
    ``ff_state`` / ``ff_memory`` layers)."""
    cdtype = jnp.dtype(cfg.compute_dtype)
    h0 = jnp.tanh(_dot(sc.mean_ctx, params["ff_state_W"], cdtype)
                  + params["ff_state_b"])
    c0 = jnp.tanh(_dot(sc.mean_ctx, params["ff_memory_W"], cdtype)
                  + params["ff_memory_b"])
    return StepState(h=h0, c=c0)


def _h_projection_weights(params: Params, cfg: ModelConfig) -> jax.Array:
    """Concatenate every h_{t-1}-dependent weight into one matrix.

    Columns: [U (4*dim) | Wd_att (attn) | W_sel (1) | Wsd_att (s_attn)?].
    The concat happens at trace time, so XLA sees a single (dim, X)
    matmul per step instead of 3-4 small ones.
    """
    cols = [params["U"], params["Wd_att"], params["W_sel"][:, None]]
    if cfg.use_spatial:
        cols.append(params["Wsd_att"])
    return jnp.concatenate(cols, axis=1)


def _h_att_weights(params: Params, cfg: ModelConfig) -> jax.Array:
    """h-projection weights for the DECODE path: attention/selector
    columns only ([Wd_att | W_sel (| Wsd_att)]) — the LSTM gate term
    h @ U instead rides in the combined gates matmul (the split saves
    the f32 (B, 4d+attn+1) materialization per decode step)."""
    cols = [params["Wd_att"], params["W_sel"][:, None]]
    if cfg.use_spatial:
        cols.append(params["Wsd_att"])
    return jnp.concatenate(cols, axis=1)


def _gates_weights(params: Params) -> jax.Array:
    """[W; U; Wc] stacked so decode computes the full LSTM preactivation
    as ONE matmul over [emb_t | h_{t-1} | ctx_t] (fewer HBM round-trips
    than three matmuls + two adds; same fp32-accumulated math)."""
    return jnp.concatenate([params["W"], params["U"], params["Wc"]], axis=0)


def _attention_core_jnp(h_att, beta_logit, pctx_k, ctx_k, ctx_mask, u_att,
                        c_att, b_sel, selector: bool
                        ) -> Tuple[jax.Array, jax.Array]:
    """Temporal attention + selector gate.

    Returns (ctx_t (Bs, Dc) fp32, alpha (Bs, K) fp32).  XLA fuses the
    tanh, the multiply and the reduction over A into one reduction, so
    the (Bs, K, A) tanh is never written to device memory.

    Beam broadcasting: the state batch ``Bs = h_att.shape[0]`` may be a
    multiple of the context batch ``Bc = pctx_k.shape[0]`` (beam search
    keeps k hypotheses per video).  The context is NOT tiled k times in
    device memory — the reduction broadcasts over the beam axis, cutting context
    read traffic by k per decode step.
    """
    bs = h_att.shape[0]
    bc = pctx_k.shape[0]
    # scores as a multiply-reduce, not a dot: XLA fuses add, tanh,
    # multiply and reduce into one reduction, where a dot_general
    # becomes a GEMM whose (Bs, K, A) operand is written out first
    if bs == bc:
        e = jnp.tanh(pctx_k + h_att[:, None, :])
        scores = jnp.sum(e * u_att.astype(e.dtype), axis=-1) + c_att
        alpha = masked_softmax(scores.astype(jnp.float32), ctx_mask,
                               axis=-1)
        ctx_t = jnp.einsum("bk,bkd->bd", alpha.astype(ctx_k.dtype),
                           ctx_k).astype(jnp.float32)
    else:
        nb = bs // bc
        hk = h_att.reshape(bc, nb, 1, h_att.shape[-1])
        e = jnp.tanh(pctx_k[:, None, :, :] + hk)            # (Bc,nb,K,A)
        scores = jnp.sum(e * u_att.astype(e.dtype), axis=-1) + c_att
        alpha = masked_softmax(scores.astype(jnp.float32),
                               ctx_mask[:, None, :], axis=-1)
        ctx_t = jnp.einsum("bjk,bkd->bjd", alpha.astype(ctx_k.dtype),
                           ctx_k).astype(jnp.float32)
        k_frames = alpha.shape[-1]
        alpha = alpha.reshape(bs, k_frames)
        ctx_t = ctx_t.reshape(bs, ctx_k.shape[-1])
    if selector:
        beta = jax.nn.sigmoid(beta_logit.astype(jnp.float32) + b_sel)
        ctx_t = ctx_t * beta[:, None]
    return ctx_t, alpha


def _spatial_core_jnp(h_satt, pregion, regions, u_s, c_s, cdtype
                      ) -> Tuple[jax.Array, jax.Array]:
    """Spatial attention over R regions per frame.

    h_satt is (Bs, s) with Bs = Bc * nb (beam broadcast against the
    un-tiled region bank).  Returns (spat (Bc, nb, K, Dr) fp32-ish,
    alpha_s (Bc, nb, K, R)).
    """
    bc = pregion.shape[0]
    bs = h_satt.shape[0]
    nb = bs // bc
    hsk = h_satt.reshape(bc, nb, 1, 1, h_satt.shape[-1])
    e_s = jnp.tanh(pregion[:, None] + hsk)          # (Bc, nb, K, R, s)
    # multiply-reduce (f32 accumulation), fused by XLA with the tanh
    e_s = jnp.sum(e_s.astype(cdtype) * u_s.astype(cdtype), axis=-1,
                  dtype=jnp.float32) + c_s
    alpha_s = masked_softmax(e_s.astype(jnp.float32), None, axis=-1)
    spat = jnp.einsum("bjkr,bkrd->bjkd", alpha_s.astype(cdtype),
                      regions.astype(cdtype))       # (Bc, nb, K, Dr)
    return spat, alpha_s


def step(params: Params, cfg: ModelConfig, state: StepState,
         sc: StepContext, emb_t: jax.Array,
         x_pre: Optional[jax.Array] = None) -> StepOut:
    """One decoder step.  ``emb_t`` is the (B, dim_word) previous-word
    embedding (teacher-forced in training, model-fed in decoding).
    ``x_pre`` optionally carries the precomputed input projection
    ``emb_t @ W + b`` (the teacher-forced train path computes it for all
    T steps in ONE matmul outside the scan)."""
    cdtype = jnp.dtype(cfg.compute_dtype)
    dim = cfg.dim
    attn = cfg.attn_dim
    h, c = state
    fused_gates = x_pre is None   # decode path: one [emb|h|ctx] matmul

    # --- single fused h-projection; the weight concat is hoisted
    # into precompute so the scan body sees a loop-invariant constant.
    # Teacher-forced training (x_pre given) folds U into it; decode
    # projects only the attention/selector columns and computes the
    # gates as one combined matmul after the attention (below) ---
    if fused_gates:
        hw = (sc.h_att_w if sc.h_att_w is not None
              else _h_att_weights(params, cfg))
        hp = _dot(h, hw, cdtype)                   # (B, attn+1[+s_attn])
        h_gates = None
        h_att = hp[:, :attn]
        beta_logit = hp[:, attn]
        sat_off = attn + 1
    else:
        hw = (sc.h_proj_w if sc.h_proj_w is not None
              else _h_projection_weights(params, cfg))
        hp = _w_dot(h, hw, cfg)                    # (B, 4d+attn+1[+s_attn])
        h_gates = hp[:, : 4 * dim]
        h_att = hp[:, 4 * dim: 4 * dim + attn]
        beta_logit = hp[:, 4 * dim + attn]
        sat_off = 4 * dim + attn + 1

    # beam broadcasting: context tensors stay at their (Bc, ...) batch;
    # only recurrent state carries the beam axis (Bs = Bc * n_beams)
    bs = h.shape[0]
    bc = sc.ctx.shape[0]
    nb = bs // bc
    ctx_k = sc.ctx                                  # (Bc, K, ctx_dim)
    pctx_k = sc.pctx                                # (Bc, K, attn)
    alpha_s = None
    if cfg.use_spatial:
        h_satt = hp[:, sat_off:]                    # (Bs, s_attn)
        # spatial scores over R regions within each frame (beam axis j
        # broadcasts against the un-tiled region bank)
        spat, alpha_s = _spatial_core_jnp(
            h_satt, sc.pregion, sc.regions, params["Us_att"],
            params["cs_att"], cdtype)
        ctx_k = ctx_k[:, None] + _dot(spat, params["W_spat_fuse"], cdtype)
        pctx_k = pctx_k[:, None] + _dot(spat, sc.w_sf_att, cdtype)
        k_f = ctx_k.shape[2]
        ctx_k = ctx_k.reshape(bs, k_f, -1)          # (Bs, K, ctx_dim)
        pctx_k = pctx_k.reshape(bs, k_f, -1)        # (Bs, K, attn)
        alpha_s = alpha_s.reshape(bs, k_f, -1)

    # --- temporal attention over K frames + selector gate ---
    ctx_mask = sc.ctx_mask
    if pctx_k.shape[0] != ctx_mask.shape[0]:
        ctx_mask = jnp.repeat(ctx_mask, nb, axis=0)  # (tiny; spatial+beam)
    ctx_t, alpha = _attention_core_jnp(
        h_att, beta_logit, pctx_k, ctx_k, ctx_mask,
        params["U_att"], params["c_att"], params["b_sel"], cfg.selector)

    # --- LSTM gates ---
    if fused_gates:
        x_cat = jnp.concatenate(
            [emb_t.astype(cdtype), h.astype(cdtype),
             ctx_t.astype(cdtype)], axis=1)
        if sc.gates_w_q is not None:
            # W8A8 dynamic: per-row activation scale, s8 x s8 -> s32
            # matmul, fp32 dequant
            x32 = x_cat.astype(jnp.float32)
            s_r = jnp.maximum(jnp.max(jnp.abs(x32), axis=1,
                                      keepdims=True), 1e-8) / 127.0
            x_q = jnp.clip(jnp.round(x32 / s_r), -127, 127
                           ).astype(jnp.int8)
            acc = jax.lax.dot_general(
                x_q, sc.gates_w_q, (((1,), (0,)), ((), ())),
                preferred_element_type=jnp.int32)
            preact = (acc.astype(jnp.float32)
                      * (s_r * sc.gates_scale[None, :]) + params["b"])
        else:
            gw = (sc.gates_w if sc.gates_w is not None
                  else _gates_weights(params))
            preact = _dot(x_cat, gw, cdtype) + params["b"]
    else:
        preact = x_pre + h_gates + _w_dot(ctx_t, params["Wc"], cfg)
    i = jax.nn.sigmoid(preact[:, 0 * dim: 1 * dim])
    f = jax.nn.sigmoid(preact[:, 1 * dim: 2 * dim])
    o = jax.nn.sigmoid(preact[:, 2 * dim: 3 * dim])
    g = jnp.tanh(preact[:, 3 * dim: 4 * dim])
    c_t = f * c + i * g
    h_t = o * jnp.tanh(c_t)
    return StepOut(h=h_t, c=c_t, ctx_t=ctx_t, alpha=alpha, alpha_s=alpha_s)


def logit_activation(params: Params, cfg: ModelConfig, h: jax.Array,
                     ctx_t: jax.Array, emb: jax.Array,
                     dropout_rng: Optional[jax.Array] = None,
                     train: bool = False) -> jax.Array:
    """The (.., dim_word) pre-vocab activation (reference ff_logit_lstm/
    ctx/prev merge + tanh + dropout) — everything of the logit stack
    except the final vocab matmul.  Split out so the decode path can
    feed it to the fused logit-tail kernel (matmul + logsumexp + top-k
    without materializing (B, n_words) logits, ``kernel.py``)."""
    cdtype = jnp.dtype(cfg.compute_dtype)
    logit = (_dot(h, params["ff_logit_lstm_W"], cdtype)
             + params["ff_logit_lstm_b"]
             + _dot(ctx_t, params["ff_logit_ctx_W"], cdtype))
    if cfg.prev_word_logit:
        logit = logit + emb  # dims match (dim_word) — reference adds emb raw
    logit = jnp.tanh(logit)
    if cfg.use_dropout and train:
        if dropout_rng is None:
            raise ValueError("train dropout requires an rng")
        keep = 1.0 - cfg.dropout_rate
        mask = jax.random.bernoulli(dropout_rng, keep, logit.shape)
        logit = jnp.where(mask, logit / keep, 0.0)
    return logit


def logits_from_states(params: Params, cfg: ModelConfig, h: jax.Array,
                       ctx_t: jax.Array, emb: jax.Array,
                       dropout_rng: Optional[jax.Array] = None,
                       train: bool = False) -> jax.Array:
    """Output projection to vocab logits (reference ff_logit_* stack).

    Shapes are arbitrary-leading: works for (B, ...) per-step in decoding
    AND (T, B, ...) whole-sequence after scan (one big
    (T*B, dim) @ (dim, dim_word) matmul instead of T small ones).
    """
    cdtype = jnp.dtype(cfg.compute_dtype)
    logit = logit_activation(params, cfg, h, ctx_t, emb,
                             dropout_rng=dropout_rng, train=train)
    return _dot(logit, params["ff_logit_W"], cdtype) + params["ff_logit_b"]
