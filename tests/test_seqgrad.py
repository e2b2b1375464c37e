"""Hand-derived sequence VJP (model/seqgrad.py) vs autodiff parity.

The fused path must be a pure implementation detail: identical forward
values and identical gradients for EVERY parameter, at float32 exactly
and at bfloat16 loosely (same rounding class as autodiff's own mixed
precision).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stvd.data.batching import gather_batch, synthetic_dataset
from stvd.model.decoder import forward_train, init_params
from stvd.train.loss import loss_fn

from conftest import small_cfg


def _setup(cfg, n=4, seed=0, ragged_mask=False):
    ds = synthetic_dataset(n_videos=n, k=cfg.n_frames, d=cfg.ctx_dim,
                           maxlen=10, seed=seed)
    dev = ds.bank.to_device()
    batch = gather_batch(dev, ds.captions, np.arange(n, dtype=np.int32))
    if ragged_mask:
        fm = np.asarray(batch["frame_mask"]).copy()
        fm[0, cfg.n_frames // 2:] = 0.0       # half-masked video
        fm[1, 1:] = 0.0                       # single-frame video
        batch["frame_mask"] = jnp.asarray(fm)
    params = init_params(jax.random.PRNGKey(7), cfg)
    return params, batch


def _cfg(**kw):
    base = dict(compute_dtype="float32", fused_seq_grad=True)
    base.update(kw)
    return small_cfg(**base)


@pytest.mark.parametrize("selector", [True, False])
def test_forward_parity_f32(selector):
    cfg = _cfg(selector=selector)
    cfg_ref = dataclasses.replace(cfg, fused_seq_grad=False)
    params, batch = _setup(cfg, ragged_mask=True)
    a = forward_train(params, cfg, batch, train=False)
    b = forward_train(params, cfg_ref, batch, train=False)
    np.testing.assert_allclose(np.asarray(a.logits), np.asarray(b.logits),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(a.alphas), np.asarray(b.alphas),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(a.nll_per_example),
                               np.asarray(b.nll_per_example), rtol=1e-5)


@pytest.mark.parametrize("selector", [True, False])
def test_grad_parity_f32_all_params(selector):
    """Every parameter's gradient matches autodiff exactly at f32 —
    including the ones the custom VJP computes by hand (U, Wd_att,
    W_sel via d[hw]; Wc; U_att; c_att; b_sel; Wc_att/b_att via d[pctx];
    W/b/Wemb via d[x_pre]; ff_state/ff_memory via d[h0/c0])."""
    cfg = _cfg(selector=selector)
    cfg_ref = dataclasses.replace(cfg, fused_seq_grad=False)
    params, batch = _setup(cfg, ragged_mask=True)
    g_new = jax.grad(lambda p: loss_fn(p, cfg, batch, train=False)[0]
                     )(params)
    g_ref = jax.grad(lambda p: loss_fn(p, cfg_ref, batch, train=False)[0]
                     )(params)
    assert set(g_new) == set(g_ref)
    for k in sorted(g_ref):
        np.testing.assert_allclose(np.asarray(g_new[k]),
                                   np.asarray(g_ref[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_grad_parity_alpha_c_regularizer():
    """alpha_c > 0 feeds a nonzero cotangent into the alphas output."""
    cfg = _cfg(alpha_c=0.5)
    cfg_ref = dataclasses.replace(cfg, fused_seq_grad=False)
    params, batch = _setup(cfg)
    g_new = jax.grad(lambda p: loss_fn(p, cfg, batch, train=False)[0]
                     )(params)
    g_ref = jax.grad(lambda p: loss_fn(p, cfg_ref, batch, train=False)[0]
                     )(params)
    for k in ("U_att", "Wd_att", "U", "Wc_att"):
        np.testing.assert_allclose(np.asarray(g_new[k]),
                                   np.asarray(g_ref[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_grad_parity_bf16_loose():
    """bfloat16 compute: same rounding class as autodiff (the wgrad
    GEMMs accumulate in f32 on the MXU, like XLA's per-step dots)."""
    cfg = _cfg(compute_dtype="bfloat16")
    cfg_ref = dataclasses.replace(cfg, fused_seq_grad=False)
    params, batch = _setup(cfg)
    g_new = jax.grad(lambda p: loss_fn(p, cfg, batch, train=False)[0]
                     )(params)
    g_ref = jax.grad(lambda p: loss_fn(p, cfg_ref, batch, train=False)[0]
                     )(params)
    for k in ("U", "Wc", "W", "Wemb", "U_att", "ff_logit_W"):
        a, b = np.asarray(g_new[k], np.float32), np.asarray(g_ref[k],
                                                            np.float32)
        denom = np.maximum(np.abs(b).max(), 1e-6)
        assert np.abs(a - b).max() / denom < 0.05, k


def test_ss_falls_back_to_autodiff():
    """Scheduled sampling keeps the autodiff path (fused_seq_grad must
    not change its results or crash)."""
    cfg2 = _cfg()
    params2, batch2 = _setup(cfg2)
    loss2, _ = loss_fn(params2, cfg2, batch2, jax.random.PRNGKey(0),
                       train=True, ss_prob=0.3)
    assert np.isfinite(float(loss2))


# ---------------------------------------------------------------------------
# Spatial path (config 2): fused_sequence_spatial vs autodiff
# ---------------------------------------------------------------------------

def _setup_spatial(cfg, n=4, seed=0, ragged_mask=False):
    ds = synthetic_dataset(n_videos=n, k=cfg.n_frames, d=cfg.ctx_dim,
                           n_regions=cfg.n_regions,
                           region_dim=cfg.region_dim, maxlen=10, seed=seed)
    dev = ds.bank.to_device()
    batch = gather_batch(dev, ds.captions, np.arange(n, dtype=np.int32))
    if ragged_mask:
        fm = np.asarray(batch["frame_mask"]).copy()
        fm[0, cfg.n_frames // 2:] = 0.0
        fm[1, 1:] = 0.0
        batch["frame_mask"] = jnp.asarray(fm)
    params = init_params(jax.random.PRNGKey(7), cfg)
    return params, batch


def _scfg(**kw):
    base = dict(compute_dtype="float32", fused_seq_grad=True,
                use_spatial=True, n_regions=3, region_dim=8)
    base.update(kw)
    return small_cfg(**base)


@pytest.mark.parametrize("selector", [True, False])
def test_spatial_forward_parity_f32(selector):
    cfg = _scfg(selector=selector)
    cfg_ref = dataclasses.replace(cfg, fused_seq_grad=False)
    params, batch = _setup_spatial(cfg, ragged_mask=True)
    a = forward_train(params, cfg, batch, train=False)
    b = forward_train(params, cfg_ref, batch, train=False)
    np.testing.assert_allclose(np.asarray(a.logits), np.asarray(b.logits),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(a.alphas), np.asarray(b.alphas),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("selector", [True, False])
def test_spatial_grad_parity_f32_all_params(selector):
    """Every parameter's gradient matches autodiff at f32 — including
    the spatial leaves the custom VJP computes by hand (Us_att/cs_att;
    W_spat_fuse via BOTH its direct arg and the w_sf_att composition;
    Ws_att/bs_att via d[pregion]; Wsd_att via d[hw])."""
    cfg = _scfg(selector=selector)
    cfg_ref = dataclasses.replace(cfg, fused_seq_grad=False)
    params, batch = _setup_spatial(cfg, ragged_mask=True)
    g_new = jax.grad(lambda p: loss_fn(p, cfg, batch, train=False)[0]
                     )(params)
    g_ref = jax.grad(lambda p: loss_fn(p, cfg_ref, batch, train=False)[0]
                     )(params)
    assert set(g_new) == set(g_ref)
    for k in sorted(g_ref):
        np.testing.assert_allclose(np.asarray(g_new[k]),
                                   np.asarray(g_ref[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_spatial_grad_parity_alpha_c():
    cfg = _scfg(alpha_c=0.5)
    cfg_ref = dataclasses.replace(cfg, fused_seq_grad=False)
    params, batch = _setup_spatial(cfg)
    g_new = jax.grad(lambda p: loss_fn(p, cfg, batch, train=False)[0]
                     )(params)
    g_ref = jax.grad(lambda p: loss_fn(p, cfg_ref, batch, train=False)[0]
                     )(params)
    for k in ("Us_att", "Wsd_att", "Ws_att", "W_spat_fuse", "U_att", "U"):
        np.testing.assert_allclose(np.asarray(g_new[k]),
                                   np.asarray(g_ref[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_spatial_grad_parity_bf16_loose():
    """bfloat16 compute: the fused spatial VJP reads pregion in bf16
    inside the scan (the oracle keeps it f32), so tolerance is the
    mixed-precision rounding class, not exactness."""
    cfg = _scfg(compute_dtype="bfloat16")
    cfg_ref = dataclasses.replace(cfg, fused_seq_grad=False)
    params, batch = _setup_spatial(cfg)
    g_new = jax.grad(lambda p: loss_fn(p, cfg, batch, train=False)[0]
                     )(params)
    g_ref = jax.grad(lambda p: loss_fn(p, cfg_ref, batch, train=False)[0]
                     )(params)
    for k in ("U", "Wc", "Us_att", "Ws_att", "W_spat_fuse", "Wsd_att"):
        a, b = np.asarray(g_new[k], np.float32), np.asarray(g_ref[k],
                                                            np.float32)
        denom = np.maximum(np.abs(b).max(), 1e-6)
        assert np.abs(a - b).max() / denom < 0.05, k


def test_spatial_fused_trains():
    """End-to-end: optimizer steps reduce the loss on the spatial path."""
    from stvd.config import TrainConfig
    from stvd.train.loop import init_train_state, make_train_step
    cfg = _scfg()
    params, batch = _setup_spatial(cfg, n=8)
    batch = dict(batch)
    batch["weight"] = jnp.ones((8,), jnp.float32)
    tcfg = TrainConfig(batch_size=8, maxlen=10, optimizer="adam", lr=1e-3)
    state = init_train_state(jax.random.PRNGKey(0), cfg, tcfg)
    step = make_train_step(cfg, tcfg)
    state, m0 = step(state, batch)
    for _ in range(20):
        state, m = step(state, batch)
    assert float(m["loss"]) < float(m0["loss"])


def test_fused_seq_grad_trains():
    """End-to-end: a few optimizer steps reduce the loss (integration
    with make_train_step + adadelta)."""
    from stvd.config import TrainConfig
    from stvd.train.loop import init_train_state, make_train_step
    cfg = _cfg()
    params, batch = _setup(cfg, n=8)
    batch = dict(batch)
    batch["weight"] = jnp.ones((8,), jnp.float32)
    tcfg = TrainConfig(batch_size=8, maxlen=10, optimizer="adam", lr=1e-3)
    state = init_train_state(jax.random.PRNGKey(0), cfg, tcfg)
    step = make_train_step(cfg, tcfg)
    state, m0 = step(state, batch)
    for _ in range(20):
        state, m = step(state, batch)
    assert float(m["loss"]) < float(m0["loss"])


def _grads(cfg, cfg_ref, params, batch):
    g_new = jax.grad(lambda p: loss_fn(p, cfg, batch, train=False)[0]
                     )(params)
    g_ref = jax.grad(lambda p: loss_fn(p, cfg_ref, batch, train=False)[0]
                     )(params)
    assert set(g_new) == set(g_ref)
    return g_new, g_ref


def _assert_close(g_new, g_ref, keys=None):
    for k in sorted(keys or g_ref):
        np.testing.assert_allclose(np.asarray(g_new[k]),
                                   np.asarray(g_ref[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def _assert_rel(g_new, g_ref, keys, bound):
    for k in keys:
        a = np.asarray(g_new[k], np.float32)
        b = np.asarray(g_ref[k], np.float32)
        denom = np.maximum(np.abs(b).max(), 1e-6)
        assert np.abs(a - b).max() / denom < bound, k


@pytest.mark.parametrize("spatial", [False, True])
def test_unrolled_scan_grad_parity_f32(spatial):
    """scan_unroll > 1 unrolls both hand-written scans; gradients stay
    equal to autodiff."""
    cfg = (_scfg if spatial else _cfg)(scan_unroll=3)
    cfg_ref = dataclasses.replace(cfg, fused_seq_grad=False)
    params, batch = (_setup_spatial if spatial else _setup)(
        cfg, ragged_mask=True)
    _assert_close(*_grads(cfg, cfg_ref, params, batch))


@pytest.mark.parametrize("selector", [True, False])
def test_spatial_grad_parity_vs_remat_autodiff(selector):
    """The spatial hand VJP against the rematerialized autodiff path
    (model.remat), the other memory lever for config 2."""
    cfg = _scfg(selector=selector)
    cfg_ref = dataclasses.replace(cfg, fused_seq_grad=False, remat=True)
    params, batch = _setup_spatial(cfg, ragged_mask=True)
    _assert_close(*_grads(cfg, cfg_ref, params, batch))


@pytest.mark.parametrize("selector", [True, False])
def test_aligned_dims_forward_parity_f32(selector):
    """Tile-aligned widths (dim = ctx_dim = 128), where XLA picks other
    fusions and GEMM tilings than at the odd test widths."""
    cfg = _cfg(selector=selector, dim=128, ctx_dim=128)
    cfg_ref = dataclasses.replace(cfg, fused_seq_grad=False)
    params, batch = _setup(cfg, ragged_mask=True)
    a = forward_train(params, cfg, batch, train=False)
    b = forward_train(params, cfg_ref, batch, train=False)
    np.testing.assert_allclose(np.asarray(a.logits), np.asarray(b.logits),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(a.alphas), np.asarray(b.alphas),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("spatial", [False, True])
def test_aligned_dims_grad_parity_f32(spatial):
    extra = dict(use_spatial=True, n_regions=4, region_dim=16) \
        if spatial else {}
    cfg = _cfg(dim=128, ctx_dim=128, **extra)
    cfg_ref = dataclasses.replace(cfg, fused_seq_grad=False)
    params, batch = (_setup_spatial if spatial else _setup)(cfg)
    _assert_close(*_grads(cfg, cfg_ref, params, batch))


@pytest.mark.parametrize("selector", [True, False])
def test_spatial_alpha_c_ragged_mask(selector):
    """alpha_c's cotangent on the alphas, with masked frames, both
    selector settings."""
    cfg = _scfg(alpha_c=0.5, selector=selector)
    cfg_ref = dataclasses.replace(cfg, fused_seq_grad=False)
    params, batch = _setup_spatial(cfg, ragged_mask=True)
    _assert_close(*_grads(cfg, cfg_ref, params, batch),
                  keys=("Us_att", "Wsd_att", "Ws_att", "W_spat_fuse",
                        "U_att", "U", "W_sel"))


def test_spatial_f32_accumulator_at_bf16_compute():
    """bf16 compute with the exact f32 pregion-cotangent accumulator
    (spatial_wgrad_dtype='float32'): the bf16 accumulator default stays
    in its rounding class."""
    cfg_b = _scfg(compute_dtype="bfloat16")
    cfg_f = dataclasses.replace(cfg_b, spatial_wgrad_dtype="float32")
    params, batch = _setup_spatial(cfg_b)
    g_b, g_f = _grads(cfg_b, cfg_f, params, batch)
    _assert_rel(g_b, g_f, ("U", "Wc", "Us_att", "Ws_att", "W_spat_fuse",
                           "Wsd_att", "bs_att", "cs_att"), 0.02)


def test_spatial_forward_parity_bf16_loose():
    cfg = _scfg(compute_dtype="bfloat16")
    cfg_ref = dataclasses.replace(cfg, fused_seq_grad=False)
    params, batch = _setup_spatial(cfg)
    a = forward_train(params, cfg, batch, train=False)
    b = forward_train(params, cfg_ref, batch, train=False)
    la = np.asarray(a.logits, np.float32)
    lb = np.asarray(b.logits, np.float32)
    assert np.abs(la - lb).max() / np.abs(lb).max() < 0.05


def test_grad_parity_bf16_wgrad_reference():
    """The fused VJP against autodiff with bf16 weight-gradient
    accumulation (model.wgrad_dtype='bfloat16')."""
    cfg = _cfg(compute_dtype="bfloat16")
    cfg_ref = dataclasses.replace(cfg, fused_seq_grad=False,
                                  wgrad_dtype="bfloat16")
    params, batch = _setup(cfg)
    _assert_rel(*_grads(cfg, cfg_ref, params, batch),
                ("U", "Wc", "W", "U_att", "Wc_att", "Wd_att"), 0.05)
