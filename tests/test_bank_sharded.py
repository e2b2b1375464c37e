"""Sharded device bank: id-addressed serving when the feature bank
outgrows one chip's HBM.

The reference holds its whole feature dict in host RAM and feeds the
GPU per batch (``data_engine.py:§Movie2Caption``); SURVEY.md §5 names
the device-level scale-out ("if feature banks exceed HBM, shard the
*bank* across chips") as future work — this makes it first-class: the
bank's video axis is sharded over a 1-D ``Mesh(('data',))``
(``FeatureBank.to_device_sharded``), and an id request runs an
explicit shard_map gather (each chip looks up the rows it owns, one
``psum_scatter`` lands each device its slice of the decode
batch) fused into the decode dispatch.

Pinned invariants, all on the 8-virtual-device conftest mesh:
  * sharded-bank captions == single-device-bank captions, exactly
    (temporal + spatial models; divisible and non-divisible chunk
    sizes, i.e. both the psum_scatter and the psum-fallback paths)
  * the bank arrays are ACTUALLY sharded (one shard's rows ≈ N/8,
    padded) — the gather may not silently replicate the operand
  * the DP AOT artifact's ids path accepts a bank sharded over the
    artifact's own serving mesh
  * the serve CLI wires --bank-shards and rejects a mesh mismatch
"""

import dataclasses

import jax
import numpy as np
import pytest

from stvd.api import Captioner
from stvd.config import Config, DecodeConfig, ModelConfig
from stvd.data.batching import synthetic_dataset
from stvd.export_aot import load_artifact, save_artifact
from stvd.model.decoder import init_params
from stvd.train.parallel import make_mesh

MCFG = ModelConfig(n_words=48, dim_word=16, dim=24, ctx_dim=32, n_frames=6,
                   compute_dtype="float32")


def _vocab():
    return synthetic_dataset(n_videos=2, k=6, d=32, maxlen=8, seed=0).vocab


def _captioner(decode_batch, spatial=False, beam=2, seed=3):
    m = (dataclasses.replace(MCFG, use_spatial=True, n_regions=4,
                             region_dim=16) if spatial else MCFG)
    cfg = Config(model=m, decode=DecodeConfig(beam_size=beam, maxlen=8,
                                              decode_batch=decode_batch))
    params = init_params(jax.random.PRNGKey(seed), m)
    return Captioner(params, cfg, _vocab()), m


def _dataset(spatial=False, n=10, seed=7):
    return synthetic_dataset(n_videos=n, k=6, d=32,
                             n_regions=4 if spatial else 0, region_dim=16,
                             maxlen=8, seed=seed)


@pytest.mark.parametrize("spatial", [False, True])
@pytest.mark.parametrize("decode_batch", [8, 5])
def test_sharded_bank_ids_match_single_device(spatial, decode_batch):
    """Sharded-bank caption_ids == single-device-bank caption_ids.

    decode_batch=8 exercises the psum_scatter (batch-sharded decode)
    path; decode_batch=5 the psum fallback (5 % 8 != 0 -> replicated
    batch).  N=10 videos over 8 shards also pins the row padding
    (10 -> 16, 2 rows/shard)."""
    ds = _dataset(spatial=spatial)
    mesh = make_mesh(jax.devices()[:8])

    cap_ref, _ = _captioner(decode_batch, spatial=spatial)
    cap_ref.attach_bank(ds.bank)
    ids = cap_ref.bank_ids
    order = [9, 0, 4, 7, 2, 5, 1, 8, 3, 6]
    want = cap_ref.caption_ids([ids[i] for i in order])

    cap, _ = _captioner(decode_batch, spatial=spatial)
    cap.attach_bank(ds.bank, mesh=mesh)
    # the bank must be genuinely sharded: 10 videos pad to 16, so each
    # of the 8 shards holds exactly 2 rows of every stream
    for k, v in cap._bank_dev.items():
        shard = v.addressable_shards[0].data
        assert v.shape[0] == 16, (k, v.shape)
        assert shard.shape[0] == 2, (k, shard.shape)
    got = cap.caption_ids([ids[i] for i in order])
    assert got == want and len(got) == 10


def test_sharded_bank_nbest_ids_match():
    ds = _dataset()
    mesh = make_mesh(jax.devices()[:8])
    cap_ref, _ = _captioner(4)
    cap_ref.attach_bank(ds.bank)
    ids = cap_ref.bank_ids
    want = cap_ref.nbest_ids(ids[:3], n=2)

    cap, _ = _captioner(4)
    cap.attach_bank(ds.bank, mesh=mesh)
    got = cap.nbest_ids(ids[:3], n=2)
    assert [[t for t, _ in row] for row in got] == \
        [[t for t, _ in row] for row in want]
    for grow, wrow in zip(got, want):
        for (_, gs), (_, ws) in zip(grow, wrow):
            assert abs(gs - ws) < 1e-4


def test_sharded_bank_pallas_step_matches():
    """The fused logit-tail kernel stays engaged under a SHARDED bank:
    gather and decode run per shard inside ONE shard_map region, so the
    tail step applies to each shard's local rows.  Pinned:
    sharded-bank captions with the tail step == single-device captions
    with it (both interpret mode on CPU)."""
    import functools
    from stvd.model import kernel as kmod
    step_fn = kmod.make_tail_step(interpret=True)
    step_fn.make_logit_tail = functools.partial(
        kmod.make_logit_tail, interpret=True, tr=16, tv=32, tk=64,
        splits=2)

    mcfg = dataclasses.replace(MCFG, n_words=256, dim_word=128)
    cfg = Config(model=mcfg, decode=DecodeConfig(beam_size=2, maxlen=6,
                                                 decode_batch=8))
    ds = synthetic_dataset(n_videos=8, k=6, d=32, maxlen=8, seed=7)
    params = init_params(jax.random.PRNGKey(3), mcfg)

    cap_ref = Captioner(params, cfg, _vocab(), step_fn=step_fn)
    cap_ref.attach_bank(ds.bank)
    ids = cap_ref.bank_ids
    want = cap_ref.caption_ids(ids)

    mesh = make_mesh(jax.devices()[:8])
    cap = Captioner(params, cfg, _vocab(), step_fn=step_fn)
    cap.attach_bank(ds.bank, mesh=mesh)
    assert cap.caption_ids(ids) == want


def test_sharded_bank_nbest_fused_no_feature_rehome(monkeypatch):
    """nbest_ids over a sharded bank runs the fused shard_map
    gather+n-best executable — no jax.device_get rehome of feature
    arrays (that would pay the full device-to-host transfer the sharded
    bank exists to avoid)."""
    ds = _dataset()
    mesh = make_mesh(jax.devices()[:8])
    cap_ref, _ = _captioner(4)
    cap_ref.attach_bank(ds.bank)
    ids = cap_ref.bank_ids
    want = cap_ref.nbest_ids(ids[:5], n=2)

    cap, _ = _captioner(4)
    cap.attach_bank(ds.bank, mesh=mesh)
    calls = []
    monkeypatch.setattr(jax, "device_get",
                        lambda *a, **k: calls.append(a) or
                        (_ for _ in ()).throw(AssertionError(
                            "feature rehome on the fused n-best path")))
    got = cap.nbest_ids(ids[:5], n=2)
    assert not calls
    assert cap._nbest_ids_jit          # the fused executable was built
    assert [[t for t, _ in row] for row in got] == \
        [[t for t, _ in row] for row in want]
    for grow, wrow in zip(got, want):
        for (_, gs), (_, ws) in zip(grow, wrow):
            assert abs(gs - ws) < 1e-4


def test_sharded_bank_dp_artifact(tmp_path):
    """A data-parallel AOT artifact serves ids from a bank sharded
    over its own serving mesh; captions match the unsharded attach."""
    ds = _dataset(n=8)
    cfg = Config(model=MCFG, decode=DecodeConfig(beam_size=2, maxlen=8,
                                                 decode_batch=4))
    params = init_params(jax.random.PRNGKey(1), MCFG)
    out = str(tmp_path / "dp_artifact")
    save_artifact(out, params, cfg, _vocab(), platforms=("cpu",),
                  batch_sizes=(4,), data_parallel=2)

    exp_ref = load_artifact(out)
    exp_ref.attach_bank(ds.bank)
    ids = exp_ref.bank_ids
    order = [3, 7, 1, 5, 0, 6, 2, 4]
    want = exp_ref.caption_ids([ids[i] for i in order])

    exp = load_artifact(out)
    assert exp._mesh is not None
    exp.attach_bank(ds.bank, mesh=exp._mesh)
    got = exp.caption_ids([ids[i] for i in order])
    assert got == want and len(got) == 8


def test_serve_cli_bank_shards(tmp_path):
    """--bank-shards N on a DP artifact must match the artifact's
    data-parallel degree; a matching value attaches sharded."""
    import argparse

    from stvd.cli.serve import build_server

    ds = _dataset(n=6)
    bank_path = str(tmp_path / "bank.npz")
    ds.bank.save(bank_path)
    cfg = Config(model=MCFG, decode=DecodeConfig(beam_size=1, maxlen=8,
                                                 decode_batch=4))
    params = init_params(jax.random.PRNGKey(2), MCFG)
    out = str(tmp_path / "artifact")
    save_artifact(out, params, cfg, _vocab(), platforms=("cpu",),
                  batch_sizes=(4,), data_parallel=2)

    def ns(shards):
        return argparse.Namespace(
            artifact=out, run_dir=None, params=None, quant=None,
            host="127.0.0.1", port=0, verbose=False,
            coalesce_wait_ms=0.0, bank=bank_path, bank_shards=shards)

    with pytest.raises(ValueError, match="data-parallel degree"):
        build_server(ns(4))
    srv = build_server(ns(2))
    try:
        assert srv.manifest["bank_shards"] == 2
        assert srv.manifest["bank_videos"] == 6
        assert srv.captioner._bank_mesh is not None
    finally:
        srv.server_close()
