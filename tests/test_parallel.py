"""Data-parallel correctness on the virtual 8-device CPU mesh
(SURVEY.md §4 'distributed without a cluster': loss/grad parity vs
single-device, explicit psum semantics, driver dry-run)."""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from stvd.config import ModelConfig, TrainConfig
from stvd.data.batching import gather_batch, synthetic_dataset
from stvd.model.decoder import init_params
from stvd.train import parallel
from stvd.train.loop import init_train_state, make_train_step
from stvd.train.loss import loss_fn

MCFG = ModelConfig(n_words=48, dim_word=16, dim=32, ctx_dim=32, n_frames=6,
                   compute_dtype="float32", use_dropout=False)
TCFG = TrainConfig(optimizer="sgd", lr=0.1, batch_size=8, clip_c=0.0,
                   donate_state=False)


def _batch(n=8):
    ds = synthetic_dataset(n_videos=n, captions_per_video=1, k=6, d=32,
                           maxlen=10, seed=0)
    dev = ds.bank.to_device()
    b = gather_batch(dev, ds.captions, np.arange(n, dtype=np.int32))
    b["weight"] = jnp.ones((n,), jnp.float32)
    return b


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8, "conftest must force 8 CPU devices"


def test_dp_train_step_matches_single_device():
    """One DP train step over the 8-device mesh must produce the same
    updated params as the single-device step (XLA psum == serial sum)."""
    batch = _batch(8)
    mesh = parallel.make_mesh()

    s_single = init_train_state(jax.random.PRNGKey(0), MCFG, TCFG)
    s_mesh = jax.device_get(s_single)  # same initial values
    s_mesh = parallel.replicate(s_mesh, mesh)

    step1 = make_train_step(MCFG, TCFG)
    stepN = make_train_step(MCFG, TCFG, mesh=mesh)
    out1, m1 = step1(s_single, batch)
    outN, mN = stepN(s_mesh, parallel.shard_batch(batch, mesh))
    np.testing.assert_allclose(float(m1["loss"]), float(mN["loss"]),
                               rtol=1e-5)
    for k in out1["params"]:
        np.testing.assert_allclose(
            np.asarray(jax.device_get(outN["params"][k])),
            np.asarray(jax.device_get(out1["params"][k])),
            rtol=1e-4, atol=1e-6, err_msg=k)


def test_shard_map_psum_grad_parity():
    """Explicit shard_map + lax.pmean gradient averaging equals the
    global gradient (pins the collective semantics of SURVEY.md §2
    row 10)."""
    from jax import shard_map

    batch = _batch(8)
    params = init_params(jax.random.PRNGKey(0), MCFG)
    mesh = parallel.make_mesh()

    def local_grads(params, batch):
        g = jax.grad(lambda p: loss_fn(p, MCFG, batch, train=False)[0])(params)
        return parallel.psum_mean_grads(g)

    batch_specs = {k: P("data") for k in batch}
    gmap = shard_map(local_grads, mesh=mesh,
                     in_specs=(P(), batch_specs), out_specs=P(),
                     check_vma=False)
    g_dist = gmap(params, batch)

    # single-device reference: mean of per-shard grads
    def shard_grad(i):
        sl = {k: v[i:i + 1] for k, v in batch.items()}
        return jax.grad(lambda p: loss_fn(p, MCFG, sl, train=False)[0])(params)

    acc = shard_grad(0)
    for i in range(1, 8):
        gi = shard_grad(i)
        acc = jax.tree.map(lambda a, b: a + b, acc, gi)
    g_ref = jax.tree.map(lambda a: a / 8.0, acc)
    for k in g_ref:
        np.testing.assert_allclose(np.asarray(g_dist[k]),
                                   np.asarray(g_ref[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_shard_map_train_step_matches_single_device():
    """The explicit-psum shard_map step == the single-device step."""
    batch = _batch(8)
    mesh = parallel.make_mesh()
    s1 = init_train_state(jax.random.PRNGKey(0), MCFG, TCFG)
    sm = parallel.replicate(jax.device_get(s1), mesh)
    step1 = make_train_step(MCFG, TCFG)
    stepS = make_train_step(MCFG, TCFG, mesh=mesh, use_shard_map=True)
    out1, m1 = step1(s1, batch)
    outS, mS = stepS(sm, parallel.shard_batch(batch, mesh))
    np.testing.assert_allclose(float(m1["loss"]), float(mS["loss"]),
                               rtol=1e-5)
    for k in out1["params"]:
        np.testing.assert_allclose(
            np.asarray(jax.device_get(outS["params"][k])),
            np.asarray(jax.device_get(out1["params"][k])),
            rtol=1e-4, atol=1e-6, err_msg=k)


def test_tp_train_step_matches_single_device():
    """3 train steps over a 2-D (2 data x 4 model) mesh — gates weights
    row-sharded, vocab logits column-sharded (parallel.TP_RULES) — must
    track the single-device trajectory; and the shardings must actually
    be applied (not silently replicated)."""
    batch = _batch(8)
    mesh = parallel.make_mesh_2d(model_parallel=4)
    assert dict(mesh.shape) == {"data": 2, "model": 4}

    s1 = init_train_state(jax.random.PRNGKey(0), MCFG, TCFG)
    st = parallel.shard_state(jax.device_get(s1), mesh)
    # the big weights really are sharded over 'model'
    assert st["params"]["U"].sharding.spec == P("model", None)
    assert st["params"]["ff_logit_W"].sharding.spec == P(None, "model")
    step1 = make_train_step(MCFG, TCFG)
    stepT = make_train_step(MCFG, TCFG, mesh=mesh)
    b_sh = parallel.shard_batch(batch, mesh)
    for _ in range(3):
        s1, m1 = step1(s1, batch)
        st, mT = stepT(st, b_sh)
    np.testing.assert_allclose(float(m1["loss"]), float(mT["loss"]),
                               rtol=1e-5)
    # output shardings preserved across steps (stable layout, no
    # per-step resharding of the state)
    assert st["params"]["U"].sharding.spec == P("model", None)
    for k in s1["params"]:
        np.testing.assert_allclose(
            np.asarray(jax.device_get(st["params"][k])),
            np.asarray(jax.device_get(s1["params"][k])),
            rtol=1e-4, atol=1e-6, err_msg=k)


def test_tp_spatial_config_trains():
    """TP over the spatial (config-2) model: one step runs and updates
    sharded params (the spatial mirror weights are in TP_RULES)."""
    mcfg = dataclasses.replace(MCFG, use_spatial=True, n_regions=4,
                               region_dim=32)
    ds = synthetic_dataset(n_videos=8, captions_per_video=1, k=6, d=32,
                           maxlen=10, seed=0, n_regions=4, region_dim=32)
    dev = ds.bank.to_device()
    batch = gather_batch(dev, ds.captions, np.arange(8, dtype=np.int32))
    batch["weight"] = jnp.ones((8,), jnp.float32)
    mesh = parallel.make_mesh_2d(model_parallel=2)
    st = parallel.shard_state(
        jax.device_get(init_train_state(jax.random.PRNGKey(0), mcfg,
                                        TCFG)), mesh)
    assert st["params"]["Ws_att"].sharding.spec == P("model", None)
    p0 = np.asarray(jax.device_get(st["params"]["Ws_att"]))
    step = make_train_step(mcfg, TCFG, mesh=mesh)
    st, m = step(st, parallel.shard_batch(batch, mesh))
    assert np.isfinite(float(m["loss"]))
    assert np.abs(np.asarray(jax.device_get(st["params"]["Ws_att"]))
                  - p0).max() > 0


def test_tp_shard_map_combination_rejected():
    mesh = parallel.make_mesh_2d(model_parallel=4)
    with pytest.raises(ValueError):
        make_train_step(MCFG, TCFG, mesh=mesh, use_shard_map=True)


def test_tp_indivisible_dims_fall_back_replicated():
    """A model dim the model axis doesn't divide must quietly replicate
    that param instead of crashing."""
    mcfg = dataclasses.replace(MCFG, n_words=50)  # 50 % 4 != 0
    mesh = parallel.make_mesh_2d(model_parallel=4)
    st = parallel.shard_state(
        jax.device_get(init_train_state(jax.random.PRNGKey(0), mcfg,
                                        TCFG)), mesh)
    assert st["params"]["ff_logit_W"].sharding.spec == P()   # V=50
    assert st["params"]["U"].sharding.spec == P("model", None)


def test_data_parallel_decode_matches_single_device():
    """Mesh-sharded batched decode == single-device decode."""
    from stvd.config import DecodeConfig
    from stvd.data.batching import synthetic_dataset
    from stvd.train.evaluate import generate_captions

    ds = synthetic_dataset(n_videos=8, captions_per_video=1,
                           k=MCFG.n_frames, d=MCFG.ctx_dim, maxlen=10,
                           seed=3)
    dev = ds.bank.to_device()
    params = init_params(jax.random.PRNGKey(1), MCFG)
    dcfg = DecodeConfig(beam_size=3, maxlen=10, decode_batch=8)
    mesh = parallel.make_mesh()
    toks1 = generate_captions(params, MCFG, dev, 8, dcfg)
    toksN = generate_captions(params, MCFG, dev, 8, dcfg, mesh=mesh)
    assert toks1 == toksN


def test_tp_decode_matches_single_device():
    """Tensor-parallel beam decode over the (2 data x 4 model) mesh —
    gates weights row-sharded, vocab logits column-sharded — must emit
    the single-device beam_decode tokens and scores exactly, and the
    params must actually be sharded (not silently replicated)."""
    from stvd.decode.beam import beam_decode
    from stvd.decode.parallel import make_tp_beam_decode, \
        shard_decode_params

    ds = synthetic_dataset(n_videos=8, captions_per_video=1,
                           k=MCFG.n_frames, d=MCFG.ctx_dim, maxlen=10,
                           seed=7)
    dev = ds.bank.to_device()
    batch = {k: dev[k] for k in ("frames", "frame_mask")}
    params = init_params(jax.random.PRNGKey(2), MCFG)

    ref = beam_decode(params, MCFG, batch, beam_size=3, maxlen=10,
                      length_norm=0.6)

    mesh = parallel.make_mesh_2d(model_parallel=4)
    p_sh = shard_decode_params(jax.device_get(params), mesh)
    assert p_sh["U"].sharding.spec == P("model", None)
    assert p_sh["ff_logit_W"].sharding.spec == P(None, "model")
    run = make_tp_beam_decode(MCFG, mesh, beam_size=3, maxlen=10,
                              length_norm=0.6)
    got = run(p_sh, parallel.shard_batch(batch, mesh))

    np.testing.assert_array_equal(np.asarray(got.tokens),
                                  np.asarray(ref.tokens))
    np.testing.assert_allclose(np.asarray(got.norm_scores),
                               np.asarray(ref.norm_scores),
                               rtol=1e-5, atol=1e-6)
    # outputs land batch-sharded over 'data' (the declared contract)
    assert got.tokens.sharding.spec == P("data")


def test_tp_decode_spatial_config():
    """TP decode over the spatial (config-2) model: the spatial mirror
    weights shard and the tokens match single-device decode."""
    from stvd.decode.beam import beam_decode
    from stvd.decode.parallel import make_tp_beam_decode, \
        shard_decode_params

    mcfg = dataclasses.replace(MCFG, use_spatial=True, n_regions=4,
                               region_dim=32)
    ds = synthetic_dataset(n_videos=8, captions_per_video=1, k=6, d=32,
                           maxlen=10, seed=9, n_regions=4, region_dim=32)
    dev = ds.bank.to_device()
    batch = {k: dev[k] for k in ("frames", "frame_mask", "regions")}
    params = init_params(jax.random.PRNGKey(4), mcfg)

    ref = beam_decode(params, mcfg, batch, beam_size=3, maxlen=10)

    mesh = parallel.make_mesh_2d(model_parallel=2)
    p_sh = shard_decode_params(jax.device_get(params), mesh)
    assert p_sh["Ws_att"].sharding.spec == P("model", None)
    run = make_tp_beam_decode(mcfg, mesh, beam_size=3, maxlen=10)
    got = run(p_sh, parallel.shard_batch(batch, mesh))
    np.testing.assert_array_equal(np.asarray(got.tokens),
                                  np.asarray(ref.tokens))


@pytest.mark.parametrize("model_parallel", [4, 8])
def test_tp_decode_large_vocab(model_parallel):
    """TP beam decode at a vocabulary and logit width where the
    single-device decode would use the fused tail: under TP the XLA
    tail runs on the column-sharded vocab matmul and the tokens still
    match single-device decode."""
    from stvd.decode.beam import beam_decode
    from stvd.decode.parallel import make_tp_beam_decode, \
        shard_decode_params

    mcfg = dataclasses.replace(MCFG, n_words=1024, dim_word=128)
    ds = synthetic_dataset(n_videos=8, captions_per_video=1,
                           k=mcfg.n_frames, d=mcfg.ctx_dim, maxlen=8,
                           seed=11)
    dev = ds.bank.to_device()
    batch = {k: dev[k] for k in ("frames", "frame_mask")}
    params = init_params(jax.random.PRNGKey(5), mcfg)

    ref = beam_decode(params, mcfg, batch, beam_size=3, maxlen=6,
                      length_norm=0.6)
    mesh = parallel.make_mesh_2d(model_parallel=model_parallel)
    p_sh = shard_decode_params(jax.device_get(params), mesh)
    assert p_sh["ff_logit_W"].sharding.spec == P(None, "model")
    run = make_tp_beam_decode(mcfg, mesh, beam_size=3, maxlen=6,
                              length_norm=0.6)
    got = run(p_sh, parallel.shard_batch(batch, mesh))
    np.testing.assert_array_equal(np.asarray(got.tokens),
                                  np.asarray(ref.tokens))
    np.testing.assert_allclose(np.asarray(got.norm_scores),
                               np.asarray(ref.norm_scores),
                               rtol=1e-5, atol=1e-6)


def test_tp_decode_int8():
    """decode_quant='int8' under TP: the s8 x s8 -> s32 gates matmul
    partitions like the bf16 one; tokens match single-device int8."""
    from stvd.decode.beam import beam_decode
    from stvd.decode.parallel import make_tp_beam_decode, \
        shard_decode_params

    mcfg = dataclasses.replace(MCFG, decode_quant="int8")
    ds = synthetic_dataset(n_videos=8, captions_per_video=1,
                           k=mcfg.n_frames, d=mcfg.ctx_dim, maxlen=8,
                           seed=13)
    dev = ds.bank.to_device()
    batch = {k: dev[k] for k in ("frames", "frame_mask")}
    params = init_params(jax.random.PRNGKey(6), mcfg)
    ref = beam_decode(params, mcfg, batch, beam_size=3, maxlen=6)
    mesh = parallel.make_mesh_2d(model_parallel=2)
    run = make_tp_beam_decode(mcfg, mesh, beam_size=3, maxlen=6)
    got = run(shard_decode_params(jax.device_get(params), mesh),
              parallel.shard_batch(batch, mesh))
    np.testing.assert_array_equal(np.asarray(got.tokens),
                                  np.asarray(ref.tokens))


def test_dryrun_multichip():
    sys.path.insert(0, "/root/repo")
    import __graft_entry__ as ge
    ge.dryrun_multichip(8)


def test_graft_entry_compiles():
    sys.path.insert(0, "/root/repo")
    import __graft_entry__ as ge
    fn, args = ge.entry()
    loss = jax.jit(fn)(*args)
    assert np.isfinite(float(loss))
