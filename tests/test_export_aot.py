"""AOT export/serving artifact roundtrip (stvd/export_aot.py).

The exported decode graph must reproduce the live Captioner exactly:
same chunking helper, same program — pinned here token-for-token on
CPU-platform exports, plus CUDA-platform exports made on this CPU host
(the Triton lowering runs; no GPU executes; chip_smoke.py loads and
serves such an artifact on the card)."""

import dataclasses

import jax
import numpy as np
import pytest

from stvd.api import Captioner
from stvd.config import Config, DecodeConfig, ModelConfig
from stvd.data.batching import synthetic_dataset
from stvd import export_aot
from stvd.export_aot import (example_batch, export_decoder, load_artifact,
                             save_artifact)
from stvd.model.decoder import init_params

MCFG = ModelConfig(n_words=48, dim_word=16, dim=24, ctx_dim=32, n_frames=6,
                   compute_dtype="float32")


def _vocab():
    return synthetic_dataset(n_videos=2, k=6, d=32, maxlen=8, seed=0).vocab


def _feats(n, m, seed=0, spatial=False, motion=False):
    rng = np.random.RandomState(seed)
    feats = rng.randn(n, m.n_frames, m.ctx_dim).astype(np.float32)
    regs = (list(rng.randn(n, m.n_frames, m.n_regions, m.region_dim)
                 .astype(np.float32)) if spatial else None)
    mots = (list(rng.randn(n, m.n_frames, m.motion_dim)
                 .astype(np.float32)) if motion else None)
    return feats, regs, mots


@pytest.mark.parametrize("beam", [1, 3])
def test_artifact_roundtrip_matches_live(tmp_path, beam):
    """Save -> load -> caption == live Captioner, greedy and beam,
    including the chunked/padded path (n = decode_batch + 1)."""
    cfg = Config(model=MCFG, decode=DecodeConfig(beam_size=beam, maxlen=8,
                                                 decode_batch=3))
    params = init_params(jax.random.PRNGKey(0), MCFG)
    vocab = _vocab()
    out = str(tmp_path / "artifact")
    manifest = save_artifact(out, params, cfg, vocab, platforms=("cpu",))
    assert manifest["decode_batch"] == 3 and manifest["beam_size"] == beam
    assert manifest["use_kernel"] is False

    served = load_artifact(out)
    feats, _, _ = _feats(4, MCFG)
    live = Captioner(params, cfg, vocab)
    assert served.caption(feats) == live.caption(feats)


def test_artifact_spatial_motion_roundtrip(tmp_path):
    """Config-2/4-shaped artifact: regions + motion streams ride the
    exported signature."""
    m = dataclasses.replace(MCFG, use_spatial=True, n_regions=4,
                            region_dim=16, use_motion=True, motion_dim=12)
    cfg = Config(model=m, decode=DecodeConfig(beam_size=2, maxlen=8,
                                              decode_batch=2))
    params = init_params(jax.random.PRNGKey(1), m)
    vocab = _vocab()
    out = str(tmp_path / "artifact")
    save_artifact(out, params, cfg, vocab, platforms=("cpu",))
    served = load_artifact(out)
    feats, regs, mots = _feats(3, m, seed=1, spatial=True, motion=True)
    live = Captioner(params, cfg, vocab)
    assert (served.caption(feats, regs, mots)
            == live.caption(feats, regs, mots))


def test_artifact_weight_swap_no_reexport(tmp_path):
    """Weights are call-time inputs: loading the artifact with different
    same-architecture params changes the output without re-export."""
    cfg = Config(model=MCFG, decode=DecodeConfig(beam_size=2, maxlen=8,
                                                 decode_batch=2))
    p0 = init_params(jax.random.PRNGKey(0), MCFG)
    p1 = init_params(jax.random.PRNGKey(7), MCFG)
    vocab = _vocab()
    out = str(tmp_path / "artifact")
    save_artifact(out, p0, cfg, vocab, platforms=("cpu",))
    feats, _, _ = _feats(2, MCFG, seed=3)
    swapped = load_artifact(out, params=p1).caption(feats)
    assert swapped == Captioner(p1, cfg, vocab).caption(feats)


# widths at which the fused logit tail engages (dim_word % 64 == 0,
# vocab >= 8 vocab tiles)
KCFG = dataclasses.replace(MCFG, n_words=1024, dim_word=64)


@pytest.mark.parametrize("beam", [1, 3])
def test_cuda_platform_export_serializes(beam):
    """platforms=('cuda',) exports from a CPU host; beam graphs carry the
    Triton logit tail as its one allowed custom call, greedy graphs keep
    the XLA path (the tail declines k = 1)."""
    cfg = Config(model=KCFG, decode=DecodeConfig(beam_size=beam, maxlen=8,
                                                 decode_batch=2))
    params = init_params(jax.random.PRNGKey(0), KCFG)
    exp = export_decoder(params, cfg, platforms=("cuda",))
    assert exp.platforms == ("cuda",)
    again = export_aot.load_exported(export_aot.dump_exported(exp))
    assert again.platforms == ("cuda",)
    assert again.mlir_module_serialized == exp.mlir_module_serialized
    has_triton = export_aot._TRITON_CALL_TARGET in exp.mlir_module()
    assert has_triton == (beam > 1)


def test_triton_call_needs_the_disabled_check():
    """jax.export refuses the Triton custom call unless that one target
    is allowed explicitly — the reason for ``_export``."""
    from jax import export as jexport
    from stvd.export_aot import _decode_run_fn
    from stvd.model.kernel import step_tail
    cfg = Config(model=KCFG, decode=DecodeConfig(beam_size=2, maxlen=8,
                                                 decode_batch=2))
    params = init_params(jax.random.PRNGKey(0), KCFG)
    run = jax.jit(_decode_run_fn(cfg, step_tail))
    batch = example_batch(cfg)
    with pytest.raises(ValueError, match="custom call"):
        jexport.export(run, platforms=["cuda"])(params, batch)
    assert export_aot._export(run, ("cuda",), True)(params, batch)


def test_kernel_multi_platform_rejected():
    cfg = Config(model=MCFG, decode=DecodeConfig(beam_size=2, maxlen=8,
                                                 decode_batch=2))
    params = init_params(jax.random.PRNGKey(0), MCFG)
    with pytest.raises(ValueError, match="cuda only"):
        export_decoder(params, cfg, platforms=("cuda", "cpu"),
                       use_kernel=True)


def test_cuda_artifact_buckets_and_nbest(tmp_path):
    """A default-platform (cuda) artifact with two buckets and n-best
    graphs, exported from the CPU host: manifest, files, kernel flag."""
    cfg = Config(model=KCFG, decode=DecodeConfig(beam_size=3, maxlen=8,
                                                 decode_batch=4))
    params = init_params(jax.random.PRNGKey(4), KCFG)
    out = str(tmp_path / "artifact")
    manifest = save_artifact(out, params, cfg, _vocab(),
                             batch_sizes=(1, 4), nbest=True)
    assert manifest["platforms"] == ["cuda"]
    assert manifest["use_kernel"] is True
    assert manifest["batch_sizes"] == [1, 4]
    for b in (1, 4):
        for kind in ("decode", "nbest"):
            assert (tmp_path / "artifact" / f"{kind}_b{b}.jaxexport"
                    ).stat().st_size > 0


def test_cuda_data_parallel_export_uses_xla_path(tmp_path):
    """A sharded cuda export keeps the XLA step (a pallas_call does not
    partition under sharding propagation)."""
    cfg = Config(model=KCFG, decode=DecodeConfig(beam_size=2, maxlen=8,
                                                 decode_batch=4))
    params = init_params(jax.random.PRNGKey(5), KCFG)
    manifest = save_artifact(str(tmp_path / "a"), params, cfg, _vocab(),
                             batch_sizes=(4,), data_parallel=2)
    assert manifest["use_kernel"] is False
    assert manifest["platforms"] == ["cuda"]
    with pytest.raises(ValueError, match="use_kernel"):
        save_artifact(str(tmp_path / "b"), params, cfg, _vocab(),
                      batch_sizes=(4,), data_parallel=2, use_kernel=True)


def test_load_check_uses_canonical_platform_names(tmp_path, monkeypatch):
    """The manifest says 'cuda' where jax.default_backend() says 'gpu':
    the loader compares jax.export's canonical names, so a cuda
    artifact loads where the current platform is cuda."""
    assert export_aot.current_platform() == "cpu"
    cfg = Config(model=KCFG, decode=DecodeConfig(beam_size=2, maxlen=8,
                                                 decode_batch=2))
    params = init_params(jax.random.PRNGKey(6), KCFG)
    out = str(tmp_path / "artifact")
    save_artifact(out, params, cfg, _vocab())
    monkeypatch.setattr(export_aot, "current_platform", lambda: "cuda")
    served = load_artifact(out)
    assert served.manifest["platforms"] == ["cuda"]
    assert sorted(served._exported) == [2]


def test_example_batch_matches_serving_shapes():
    m = dataclasses.replace(MCFG, use_spatial=True, n_regions=4,
                            region_dim=16)
    cfg = Config(model=m, decode=DecodeConfig(beam_size=2, maxlen=8,
                                              decode_batch=3))
    b = example_batch(cfg)
    assert b["frames"].shape == (3, 6, 32)
    assert b["regions"].shape == (3, 6, 4, 16)
    assert b["frame_mask"].shape == (3, 6)
    assert str(b["frames"].dtype) == m.compute_dtype


def test_artifact_int8_serving_path(tmp_path):
    """decode_quant='int8' is traced INTO the artifact (W8A8 gates
    matmul); weights remain f32 call-time inputs.  The artifact must
    match the live int8 Captioner."""
    m = dataclasses.replace(MCFG, decode_quant="int8")
    cfg = Config(model=m, decode=DecodeConfig(beam_size=2, maxlen=8,
                                              decode_batch=2))
    params = init_params(jax.random.PRNGKey(0), m)
    vocab = _vocab()
    out = str(tmp_path / "artifact")
    save_artifact(out, params, cfg, vocab, platforms=("cpu",))
    feats, _, _ = _feats(3, m, seed=5)
    assert (load_artifact(out).caption(feats)
            == Captioner(params, cfg, vocab).caption(feats))


def test_load_artifact_platform_mismatch(tmp_path):
    """Loading a cuda-only artifact on a cpu backend fails fast with a
    clear error instead of a cryptic XLA platform failure at call
    time."""
    cfg = Config(model=MCFG, decode=DecodeConfig(beam_size=2, maxlen=8,
                                                 decode_batch=2))
    params = init_params(jax.random.PRNGKey(0), MCFG)
    out = str(tmp_path / "artifact")
    save_artifact(out, params, cfg, _vocab(), platforms=("cuda",))
    with pytest.raises(ValueError, match="re-export"):
        load_artifact(out)


def test_artifact_bf16_compute_roundtrip(tmp_path):
    """compute_dtype='bfloat16' (the production numeric config)
    exports and roundtrips on CPU too — the artifact matches the live
    bf16 Captioner."""
    m = dataclasses.replace(MCFG, compute_dtype="bfloat16")
    cfg = Config(model=m, decode=DecodeConfig(beam_size=2, maxlen=8,
                                              decode_batch=2))
    params = init_params(jax.random.PRNGKey(2), m)
    vocab = _vocab()
    out = str(tmp_path / "artifact")
    save_artifact(out, params, cfg, vocab, platforms=("cpu",))
    feats, _, _ = _feats(3, m, seed=9)
    assert (load_artifact(out).caption(feats)
            == Captioner(params, cfg, vocab).caption(feats))


@pytest.mark.parametrize("n", [1, 2, 3, 5, 7])
def test_chunked_caption_size_invariance(n):
    """chunked_caption must give identical captions for any request
    size/padding split: captions of the first n of a 7-video batch ==
    first n captions of the full batch (decode_batch=3 forces varied
    chunk/pad layouts across n)."""
    cfg = Config(model=MCFG, decode=DecodeConfig(beam_size=2, maxlen=8,
                                                 decode_batch=3))
    params = init_params(jax.random.PRNGKey(0), MCFG)
    cap = Captioner(params, cfg, _vocab())
    feats, _, _ = _feats(7, MCFG, seed=11)
    full = cap.caption(feats)
    assert cap.caption(feats[:n]) == full[:n]


@pytest.mark.parametrize("n", [1, 2, 4, 5, 9])
def test_bucketed_artifact_routes_and_matches_live(tmp_path, n):
    """batch_sizes=(2, 4): bulk chunks ride b=4, remainders pick the
    smallest graph that fits (n=1 -> b=2 graph; n=5 -> 4 + 1-on-b=2).
    Captions must equal the live Captioner for every request size."""
    cfg = Config(model=MCFG, decode=DecodeConfig(beam_size=2, maxlen=8,
                                                 decode_batch=4))
    params = init_params(jax.random.PRNGKey(0), MCFG)
    vocab = _vocab()
    out = str(tmp_path / "artifact")
    manifest = save_artifact(out, params, cfg, vocab, platforms=("cpu",),
                             batch_sizes=(4, 2))
    assert manifest["batch_sizes"] == [2, 4]
    import os as _os
    assert _os.path.exists(_os.path.join(out, "decode_b2.jaxexport"))
    assert _os.path.exists(_os.path.join(out, "decode_b4.jaxexport"))
    served = load_artifact(out)
    feats, _, _ = _feats(n, MCFG, seed=n)
    live = Captioner(params, cfg, vocab)
    assert served.caption(feats) == live.caption(feats)


def test_nbest_artifact_matches_live(tmp_path):
    """nbest=True export: ExportedCaptioner.caption_nbest == live
    Captioner.caption_nbest (texts and scores), both rankings, plus the
    chunked path (request > exported batch) and the raw-features
    nbest() wrapper."""
    cfg = Config(model=MCFG, decode=DecodeConfig(beam_size=3, maxlen=8,
                                                 decode_batch=2,
                                                 length_norm=0.6))
    params = init_params(jax.random.PRNGKey(5), MCFG)
    vocab = _vocab()
    out = str(tmp_path / "artifact")
    manifest = save_artifact(out, params, cfg, vocab, platforms=("cpu",),
                             nbest=True)
    assert manifest["nbest"] is True
    served = load_artifact(out)
    assert sorted(served._nbest) == [2]

    live = Captioner(params, cfg, vocab)
    feats, _, _ = _feats(5, MCFG, seed=7)   # 5 > decode_batch=2: chunked
    from stvd.api import pack_request
    batch = pack_request(MCFG, feats)
    for norm in (True, False):
        got = served.caption_nbest(batch, norm=norm)
        want = live.caption_nbest(batch, norm=norm)
        assert [[t for t, _ in v] for v in got] \
            == [[t for t, _ in v] for v in want]
        np.testing.assert_allclose(
            [[s for _, s in v] for v in got],
            [[s for _, s in v] for v in want], rtol=1e-5, atol=1e-6)
    # n caps the list; nbest() packs raw features identically
    top1 = served.nbest(feats, n=1)
    assert all(len(v) == 1 for v in top1)
    assert [v[0][0] for v in top1] == [v[0][0] for v in live.nbest(feats, n=1)]
    # entry 0 under norm ranking == the caption the decode graph picks
    assert [v[0][0] for v in top1] == served.caption(feats)


def test_nbest_absent_raises(tmp_path):
    cfg = Config(model=MCFG, decode=DecodeConfig(beam_size=2, maxlen=8,
                                                 decode_batch=2))
    params = init_params(jax.random.PRNGKey(6), MCFG)
    out = str(tmp_path / "artifact")
    save_artifact(out, params, cfg, _vocab(), platforms=("cpu",))
    served = load_artifact(out)
    feats, _, _ = _feats(2, MCFG)
    with pytest.raises(ValueError, match="no n-best graphs"):
        served.nbest(feats)


def test_nbest_export_requires_beam(tmp_path):
    cfg = Config(model=MCFG, decode=DecodeConfig(beam_size=1, maxlen=8,
                                                 decode_batch=2))
    params = init_params(jax.random.PRNGKey(7), MCFG)
    with pytest.raises(ValueError, match="beam_size > 1"):
        save_artifact(str(tmp_path / "a"), params, cfg, _vocab(),
                      platforms=("cpu",), nbest=True)


def test_data_parallel_artifact_matches_single_device(tmp_path):
    """data_parallel=4 export on the virtual CPU mesh: the sharded
    graph's captions and n-best lists equal the single-device live
    Captioner's, including the bucketed + chunked request path."""
    cfg = Config(model=MCFG, decode=DecodeConfig(beam_size=3, maxlen=8,
                                                 decode_batch=8,
                                                 length_norm=0.6))
    params = init_params(jax.random.PRNGKey(11), MCFG)
    vocab = _vocab()
    out = str(tmp_path / "artifact")
    manifest = save_artifact(out, params, cfg, vocab, platforms=("cpu",),
                             batch_sizes=(4, 8), nbest=True,
                             data_parallel=4)
    assert manifest["data_parallel"] == 4
    served = load_artifact(out)
    assert served._mesh is not None and served._mesh.shape["data"] == 4

    live = Captioner(params, cfg, vocab)
    feats, _, _ = _feats(10, MCFG, seed=11)   # bulk 8 + remainder on b=4
    assert served.caption(feats) == live.caption(feats)
    got = served.nbest(feats, n=2)
    want = live.nbest(feats, n=2)
    assert [[t for t, _ in v] for v in got] \
        == [[t for t, _ in v] for v in want]


def test_data_parallel_batch_divisibility(tmp_path):
    cfg = Config(model=MCFG, decode=DecodeConfig(beam_size=2, maxlen=8,
                                                 decode_batch=6))
    params = init_params(jax.random.PRNGKey(12), MCFG)
    with pytest.raises(ValueError, match="divisible"):
        save_artifact(str(tmp_path / "a"), params, cfg, _vocab(),
                      platforms=("cpu",), batch_sizes=(6,),
                      data_parallel=4)


def test_data_parallel_needs_devices(tmp_path):
    from stvd.export_aot import _serving_mesh
    with pytest.raises(ValueError, match="devices"):
        _serving_mesh(64)


def test_dp_call_wrapper_is_memoized(tmp_path):
    """Repeated requests reuse one jit wrapper per exported graph (a
    fresh jax.jit per request would retrace every call)."""
    cfg = Config(model=MCFG, decode=DecodeConfig(beam_size=2, maxlen=8,
                                                 decode_batch=4))
    params = init_params(jax.random.PRNGKey(14), MCFG)
    out = str(tmp_path / "artifact")
    save_artifact(out, params, cfg, _vocab(), platforms=("cpu",),
                  batch_sizes=(4,), data_parallel=4)
    served = load_artifact(out)
    exp = served._exported[4]
    assert served._call_fn(exp) is served._call_fn(exp)
    feats, _, _ = _feats(4, MCFG, seed=14)
    a = served.caption(feats)
    b = served.caption(feats)
    assert a == b and len(served._call_cache) == 1


def test_dp_artifact_weight_swap(tmp_path):
    """params= override composes with the serving mesh (weights are
    re-replicated at load): swapped weights change output, and the
    swapped DP captions equal the swapped single-device captions."""
    cfg = Config(model=MCFG, decode=DecodeConfig(beam_size=2, maxlen=8,
                                                 decode_batch=4))
    p1 = init_params(jax.random.PRNGKey(21), MCFG)
    p2 = init_params(jax.random.PRNGKey(22), MCFG)
    out = str(tmp_path / "artifact")
    save_artifact(out, p1, cfg, _vocab(), platforms=("cpu",),
                  batch_sizes=(4,), data_parallel=4)
    feats, _, _ = _feats(4, MCFG, seed=23)
    swapped = load_artifact(out, params=p2)
    live2 = Captioner(p2, cfg, _vocab())
    assert swapped.caption(feats) == live2.caption(feats)


def test_model_parallel_artifact_matches_single_device(tmp_path):
    """model_parallel=4 x data_parallel=2 export on the virtual 8-device
    CPU mesh: the TP-sharded graph's captions equal the single-device
    live Captioner's (params split per TP_RULES, batch over 'data'),
    including bucketed routing and the manifest round-trip."""
    cfg = Config(model=MCFG, decode=DecodeConfig(beam_size=3, maxlen=8,
                                                 decode_batch=4,
                                                 length_norm=0.6))
    params = init_params(jax.random.PRNGKey(31), MCFG)
    vocab = _vocab()
    out = str(tmp_path / "artifact")
    manifest = save_artifact(out, params, cfg, vocab, platforms=("cpu",),
                             batch_sizes=(2, 4), data_parallel=2,
                             model_parallel=4)
    assert manifest["model_parallel"] == 4
    assert manifest["data_parallel"] == 2
    assert manifest["use_kernel"] is False
    served = load_artifact(out)
    assert served._mesh is not None
    assert served._mesh.shape["data"] == 2
    assert served._mesh.shape["model"] == 4

    live = Captioner(params, cfg, vocab)
    feats, _, _ = _feats(6, MCFG, seed=31)   # bulk 4 + remainder on b=2
    assert served.caption(feats) == live.caption(feats)


def test_model_parallel_rejects_kernel(tmp_path):
    """TP serving graphs run the XLA step (a pallas_call does not
    partition under sharding propagation) — explicit use_kernel=True
    with model_parallel must fail loudly, not silently mis-shard."""
    cfg = Config(model=MCFG, decode=DecodeConfig(beam_size=2, maxlen=8,
                                                 decode_batch=4))
    params = init_params(jax.random.PRNGKey(32), MCFG)
    with pytest.raises(ValueError, match="use_kernel"):
        save_artifact(str(tmp_path / "a"), params, cfg, _vocab(),
                      platforms=("cpu",), batch_sizes=(4,),
                      model_parallel=4, use_kernel=True)


def test_model_parallel_weight_swap(tmp_path):
    """params= override composes with the TP mesh: swapped weights are
    re-sharded per TP_RULES at load and match the live Captioner."""
    cfg = Config(model=MCFG, decode=DecodeConfig(beam_size=2, maxlen=8,
                                                 decode_batch=4))
    p1 = init_params(jax.random.PRNGKey(33), MCFG)
    p2 = init_params(jax.random.PRNGKey(34), MCFG)
    out = str(tmp_path / "artifact")
    save_artifact(out, p1, cfg, _vocab(), platforms=("cpu",),
                  batch_sizes=(4,), model_parallel=8)
    feats, _, _ = _feats(4, MCFG, seed=35)
    swapped = load_artifact(out, params=p2)
    live2 = Captioner(p2, cfg, _vocab())
    assert swapped.caption(feats) == live2.caption(feats)


def test_artifact_format_needs_no_flatbuffers(tmp_path, monkeypatch):
    """Artifacts are written and read without jax.export's flatbuffers
    serializer (absent from some GPU installations): blocking the
    package changes nothing, sharded graphs included."""
    import builtins
    real_import = builtins.__import__

    def no_flatbuffers(name, *a, **k):
        if name == "flatbuffers" or name.startswith("flatbuffers."):
            raise ImportError("flatbuffers blocked")
        return real_import(name, *a, **k)

    import sys as _sys
    for mod in [m for m in _sys.modules if "serialization" in m
                and m.startswith("jax._src.export")]:
        monkeypatch.delitem(_sys.modules, mod)
    monkeypatch.setattr(builtins, "__import__", no_flatbuffers)
    cfg = Config(model=MCFG, decode=DecodeConfig(beam_size=2, maxlen=8,
                                                 decode_batch=4))
    params = init_params(jax.random.PRNGKey(8), MCFG)
    out = str(tmp_path / "artifact")
    save_artifact(out, params, cfg, _vocab(), platforms=("cpu",),
                  batch_sizes=(4,), data_parallel=2)
    served = load_artifact(out)
    feats, _, _ = _feats(4, MCFG, seed=9)
    assert served.caption(feats) == Captioner(params, cfg,
                                              _vocab()).caption(feats)


def test_load_exported_rejects_other_files():
    import pickle
    with pytest.raises(ValueError, match="not an stvd"):
        export_aot.load_exported(pickle.dumps({"format": "other"}))
