"""The fused logit-tail kernel (Pallas, Triton route) and the plain XLA
paths that replaced the other hand kernels.

The tail runs here in the Pallas interpreter (``interpret=True``); the
same kernel compiles for the GPU, where chip_smoke.py checks it at full
width.  The plain attention cores are checked against float64 NumPy.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stvd.data.batching import gather_batch, synthetic_dataset
from stvd.decode.beam import beam_decode
from stvd.decode.greedy import greedy_decode
from stvd.model import kernel as kmod
from stvd.model import step as smod
from stvd.model.decoder import init_params

from conftest import small_cfg

# small tiles keep the interpreter quick; rows/vocab below are chosen so
# that both the row padding and the vocab padding paths run
_TILES = dict(tr=16, tv=64, tk=64, splits=2)


def _tail(w, b, k, **kw):
    return kmod.make_logit_tail(w, b, k, interpret=True,
                                **dict(_TILES, **kw))


def _reference(x, w, b, k):
    logits = jnp.dot(x, w, preferred_element_type=jnp.float32) + b
    vals, idx = jax.lax.top_k(logits, k)
    return vals, idx, jax.nn.logsumexp(logits, axis=-1)


# ---------------------------------------------------------------------------
# the tail against log_softmax + lax.top_k
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [2, 5, 8])
@pytest.mark.parametrize("v", [1000, 1408])
def test_logit_tail_matches_topk_and_logsumexp(k, v, dtype):
    """vals/idx equal lax.top_k of the materialized logits (same index
    order), lse equals logsumexp; V = 1000 is no multiple of the split
    width (padded vocab), rows = 24 no multiple of the row tile."""
    rng = np.random.RandomState(k + v)
    dt = jnp.dtype(dtype)
    x = jnp.asarray(rng.randn(24, 128), dt)
    w = jnp.asarray(rng.randn(128, v) * 0.1, dt)
    b = jnp.asarray(rng.randn(v), jnp.float32)
    vals, idx, lse = _tail(w, b, k)(x)
    rv, ri, rl = _reference(x, w, b, k)
    assert vals.shape == (24, k) and idx.shape == (24, k)
    np.testing.assert_array_equal(np.asarray(idx), np.asarray(ri))
    np.testing.assert_allclose(np.asarray(vals), np.asarray(rv),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(lse), np.asarray(rl),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k", [2, 5, 8])
def test_logit_tail_exact_ties_take_lowest_index(k):
    """All-equal logits: the top-k are the k lowest indices (lax.top_k's
    rule), and lse = log V exactly; the padded columns never surface."""
    dw, v = 64, 900
    tail = _tail(jnp.zeros((dw, v)), jnp.zeros((v,)), k)
    vals, idx, lse = tail(jnp.zeros((8, dw)))
    np.testing.assert_array_equal(np.asarray(idx),
                                  np.tile(np.arange(k), (8, 1)))
    np.testing.assert_allclose(np.asarray(lse), np.log(v), rtol=1e-6)
    assert float(jnp.max(jnp.abs(vals))) == 0.0


def test_logit_tail_ties_across_splits_and_tiles():
    """Equal maxima placed in different vocab tiles and different splits
    come back lowest index first."""
    dw, v, k = 64, 1024, 5
    b = np.zeros(v, np.float32)
    hot = [900, 17, 513, 64, 511, 3]      # spans both splits, many tiles
    b[hot] = 5.0
    tail = _tail(jnp.zeros((dw, v)), jnp.asarray(b), k)
    _, idx, _ = tail(jnp.zeros((4, dw)))
    np.testing.assert_array_equal(np.asarray(idx[0]), sorted(hot)[:k])


@pytest.mark.parametrize("rows", [1, 9, 33])
def test_logit_tail_pads_rows(rows):
    """Row counts off the row tile pad with zero rows and slice back."""
    rng = np.random.RandomState(rows)
    x = jnp.asarray(rng.randn(rows, 64), jnp.float32)
    w = jnp.asarray(rng.randn(64, 700) * 0.1, jnp.float32)
    b = jnp.asarray(rng.randn(700), jnp.float32)
    vals, idx, lse = _tail(w, b, 3)(x)
    rv, ri, rl = _reference(x, w, b, 3)
    assert lse.shape == (rows,)
    np.testing.assert_array_equal(np.asarray(idx), np.asarray(ri))
    np.testing.assert_allclose(np.asarray(lse), np.asarray(rl), rtol=1e-5)


@pytest.mark.parametrize("case", ["greedy_k1", "k9", "dw_unaligned",
                                  "vocab_too_small"])
def test_logit_tail_declines(case):
    """Shapes the kernel does not take return None, and the decode loops
    keep the XLA path.  Greedy (k = 1) is declined on purpose: XLA's
    log-softmax + argmax was measured faster end to end (PERF.md)."""
    w, b, k = jnp.zeros((128, 2048)), jnp.zeros((2048,)), 5
    if case == "greedy_k1":
        k = 1
    elif case == "k9":
        k = 9
    elif case == "dw_unaligned":
        w = jnp.zeros((100, 2048))
    else:
        w, b = jnp.zeros((128, 100)), jnp.zeros((100,))
    assert kmod.make_logit_tail(w, b, k) is None


def test_merge_splits_is_exact():
    """The cross-split merge equals top-k / logsumexp over the whole
    row, ties included (splits concatenate in vocabulary order)."""
    rng = np.random.RandomState(0)
    logits = rng.randint(0, 6, (7, 4, 32)).astype(np.float32)  # ties
    k = 5
    vals, idx, m, s = [], [], [], []
    for j in range(4):
        part = jnp.asarray(logits[:, j])
        v_j, i_j = jax.lax.top_k(part, k)
        vals.append(jnp.pad(v_j, ((0, 0), (0, 3))))
        idx.append(jnp.pad(i_j + 32 * j, ((0, 0), (0, 3))))
        m_j = jnp.max(part, axis=1)
        m.append(m_j)
        s.append(jnp.sum(jnp.exp(part - m_j[:, None]), axis=1))
    v2, i2, lse = kmod._merge_splits(jnp.stack(vals), jnp.stack(idx),
                                     jnp.stack(m), jnp.stack(s), k)
    full = jnp.asarray(logits.reshape(7, 128))
    rv, ri = jax.lax.top_k(full, k)
    np.testing.assert_array_equal(np.asarray(i2), np.asarray(ri))
    np.testing.assert_array_equal(np.asarray(v2), np.asarray(rv))
    np.testing.assert_allclose(np.asarray(lse),
                               np.asarray(jax.nn.logsumexp(full, -1)),
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# choosing the kernel
# ---------------------------------------------------------------------------

def test_production_selector_never_picks_kernel_on_cpu():
    assert kmod.get_step_fn(None) is smod.step
    assert kmod.get_step_fn(False) is smod.step
    assert kmod.get_step_fn(True) is kmod.step_tail
    assert getattr(smod.step, "make_logit_tail", None) is None


def test_compiled_kernel_off_gpu_raises():
    """Asking for the compiled kernel off the GPU raises; nothing falls
    back to the interpreter silently."""
    w = jnp.zeros((128, 2048))
    tail = kmod.make_logit_tail(w, jnp.zeros((2048,)), 5)
    with pytest.raises(Exception, match="interpret"):
        jax.block_until_ready(tail(jnp.zeros((8, 128))))


@pytest.mark.gpu
def test_compiled_logit_tail_matches_reference(gpu_device):
    """The Triton-compiled tail at the msvd-beam shape (chip_smoke.py
    runs the same check on the card)."""
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.randn(1920, 512), jnp.bfloat16)
    w = jnp.asarray(rng.randn(512, 13056) * 0.05, jnp.bfloat16)
    b = jnp.asarray(rng.randn(13056), jnp.float32)
    vals, idx, lse = kmod.make_logit_tail(w, b, 5)(x)
    rv, ri, rl = _reference(x, w, b, 5)
    assert float(jnp.mean(idx == ri)) > 0.99
    np.testing.assert_allclose(np.asarray(lse), np.asarray(rl), rtol=1e-4)


# ---------------------------------------------------------------------------
# decode with the tail == decode without it
# ---------------------------------------------------------------------------

def _decode_setup(cfg, n=4, seed=0):
    ds = synthetic_dataset(n_videos=n, k=cfg.n_frames, d=cfg.ctx_dim,
                           n_regions=cfg.n_regions if cfg.use_spatial else 0,
                           region_dim=cfg.region_dim, maxlen=10, seed=seed)
    dev = ds.bank.to_device()
    batch = gather_batch(dev, ds.captions, np.arange(n, dtype=np.int32))
    return init_params(jax.random.PRNGKey(3), cfg), batch


def _interp_tail_step():
    step = kmod.make_tail_step(interpret=True)
    step.make_logit_tail = functools.partial(
        kmod.make_logit_tail, interpret=True, **_TILES)
    return step


@pytest.mark.parametrize("spatial", [False, True])
@pytest.mark.parametrize("beam", [2, 3, 5])
def test_beam_decode_with_tail_matches_xla(beam, spatial):
    """Token-for-token equal beam decode with and without the fused tail
    (a vocabulary large enough for the kernel to engage)."""
    extra = dict(use_spatial=True, n_regions=3, region_dim=8) \
        if spatial else {}
    cfg = small_cfg(n_words=1024, dim_word=64, **extra)
    params, batch = _decode_setup(cfg, seed=beam)
    ref = beam_decode(params, cfg, batch, beam_size=beam, maxlen=8)
    ker = beam_decode(params, cfg, batch, beam_size=beam, maxlen=8,
                      step_fn=_interp_tail_step())
    np.testing.assert_array_equal(np.asarray(ref.tokens),
                                  np.asarray(ker.tokens))
    np.testing.assert_allclose(np.asarray(ref.scores),
                               np.asarray(ker.scores), rtol=1e-4, atol=1e-4)


def test_greedy_decode_with_tail_step_is_xla_path():
    """Greedy declines the kernel, so the tail step's greedy decode is
    the XLA decode exactly."""
    cfg = small_cfg(n_words=1024, dim_word=64)
    params, batch = _decode_setup(cfg)
    ref = greedy_decode(params, cfg, batch, maxlen=8)
    got = greedy_decode(params, cfg, batch, maxlen=8,
                        step_fn=_interp_tail_step())
    np.testing.assert_array_equal(np.asarray(ref.tokens),
                                  np.asarray(got.tokens))
    np.testing.assert_array_equal(np.asarray(ref.scores),
                                  np.asarray(got.scores))


# ---------------------------------------------------------------------------
# the plain attention cores against float64 NumPy
# ---------------------------------------------------------------------------

def _np_softmax(s, mask):
    s = np.where(mask > 0, s, -np.inf)
    m = np.max(s, axis=-1, keepdims=True)
    e = np.where(mask > 0, np.exp(s - m), 0.0)
    return e / np.maximum(e.sum(-1, keepdims=True), 1e-20)


def _np_attention(h_att, beta, pctx, ctx, mask, u, c_att, b_sel, selector):
    bc, nb = pctx.shape[0], h_att.shape[0] // pctx.shape[0]
    h = h_att.reshape(bc, nb, 1, -1)
    e = np.tanh(pctx[:, None] + h)                       # (Bc,nb,K,A)
    scores = (e * u).sum(-1) + c_att
    alpha = _np_softmax(scores, mask[:, None, :])
    ctx_t = np.einsum("bjk,bkd->bjd", alpha, ctx)
    alpha = alpha.reshape(bc * nb, -1)
    ctx_t = ctx_t.reshape(bc * nb, -1)
    if selector:
        ctx_t = ctx_t / (1.0 + np.exp(-(beta + b_sel)))[:, None]
    return ctx_t, alpha


@pytest.mark.parametrize("nb", [1, 5])
@pytest.mark.parametrize("selector", [True, False])
@pytest.mark.parametrize("mask_kind", ["full", "ragged", "single_frame"])
def test_attention_core_matches_float64(mask_kind, selector, nb):
    rng = np.random.RandomState(nb * 7 + selector)
    bc, k, a, dc = 4, 6, 16, 24
    h_att = rng.randn(bc * nb, a)
    beta = rng.randn(bc * nb)
    pctx = rng.randn(bc, k, a)
    ctx = rng.randn(bc, k, dc)
    u = rng.randn(a)
    mask = np.ones((bc, k))
    if mask_kind == "ragged":
        mask = (rng.rand(bc, k) > 0.4).astype(np.float64)
        mask[:, 0] = 1.0
    elif mask_kind == "single_frame":
        mask[:, 1:] = 0.0
    ref_ctx, ref_a = _np_attention(h_att, beta, pctx, ctx, mask, u, 0.1,
                                   -0.2, selector)
    f32 = lambda z: jnp.asarray(z, jnp.float32)  # noqa: E731
    got_ctx, got_a = smod._attention_core_jnp(
        f32(h_att), f32(beta), f32(pctx), f32(ctx), f32(mask), f32(u),
        jnp.float32(0.1), jnp.float32(-0.2), selector)
    np.testing.assert_allclose(np.asarray(got_a), ref_a, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(got_ctx), ref_ctx, rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("nb", [1, 3])
def test_spatial_core_matches_float64(nb):
    rng = np.random.RandomState(nb)
    bc, k, r, s, dr = 2, 3, 4, 8, 5
    h = rng.randn(bc * nb, s)
    pregion = rng.randn(bc, k, r, s)
    regions = rng.randn(bc, k, r, dr)
    u = rng.randn(s)
    e = np.tanh(pregion[:, None] + h.reshape(bc, nb, 1, 1, s))
    sc = (e * u).sum(-1) + 0.3
    alpha = _np_softmax(sc, np.ones_like(sc))
    spat = np.einsum("bjkr,bkrd->bjkd", alpha, regions)
    f32 = lambda z: jnp.asarray(z, jnp.float32)  # noqa: E731
    got_spat, got_alpha = smod._spatial_core_jnp(
        f32(h), f32(pregion), f32(regions), f32(u), jnp.float32(0.3),
        jnp.float32)
    np.testing.assert_allclose(np.asarray(got_alpha), alpha, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(got_spat), spat, rtol=1e-4,
                               atol=1e-5)
