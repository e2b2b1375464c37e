"""HTTP serving daemon (stvd/cli/serve.py).

The reference has no serving path at all (SURVEY.md §3.3: per-video,
per-step host round-trips inside metrics.py); serve.py is the
production loop around the AOT artifacts.  Pinned here: served
captions == direct captioner captions over both wire formats, the
health/manifest endpoints, error handling, and the live-Captioner
binding.
"""

import dataclasses
import json
import threading

import http.client
import jax
import numpy as np
import pytest

from stvd.api import Captioner
from stvd.cli.serve import (CaptionServer, build_server,
                            encode_npz_request, request_captions)
from stvd.config import Config, DecodeConfig, ModelConfig
from stvd.data.batching import synthetic_dataset
from stvd.export_aot import load_artifact, save_artifact
from stvd.model.decoder import init_params

MCFG = ModelConfig(n_words=48, dim_word=16, dim=24, ctx_dim=32, n_frames=6,
                   compute_dtype="float32")


def _vocab():
    return synthetic_dataset(n_videos=2, k=6, d=32, maxlen=8, seed=0).vocab


def _artifact(tmp_path, beam=2, spatial=False):
    m = (dataclasses.replace(MCFG, use_spatial=True, n_regions=4,
                             region_dim=16) if spatial else MCFG)
    cfg = Config(model=m, decode=DecodeConfig(beam_size=beam, maxlen=8,
                                              decode_batch=3))
    params = init_params(jax.random.PRNGKey(0), m)
    out = str(tmp_path / "artifact")
    save_artifact(out, params, cfg, _vocab(), platforms=("cpu",))
    return out, params, cfg


class _Srv:
    """Run a CaptionServer on an ephemeral port in a daemon thread."""

    def __init__(self, server: CaptionServer):
        self.server = server
        self.port = server.server_port
        self.thread = threading.Thread(target=server.serve_forever,
                                       daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read().decode())
    finally:
        conn.close()


def _post(port, path, body, content_type):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", path, body=body,
                     headers={"Content-Type": content_type})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read().decode())
    finally:
        conn.close()


def test_served_captions_match_direct(tmp_path):
    """npz wire format end-to-end == direct ExportedCaptioner, including
    a request larger than decode_batch (exercises chunking/padding
    through the HTTP layer)."""
    out, _, cfg = _artifact(tmp_path)
    cap = load_artifact(out)
    feats = np.random.RandomState(0).randn(
        4, MCFG.n_frames, MCFG.ctx_dim).astype(np.float32)
    with _Srv(CaptionServer(cap, port=0, manifest=cap.manifest)) as s:
        served = request_captions("127.0.0.1", s.port, feats)
    assert served == cap.caption(feats)
    assert len(served) == 4


def test_json_wire_format_matches_npz(tmp_path):
    out, _, _ = _artifact(tmp_path)
    cap = load_artifact(out)
    feats = np.random.RandomState(1).randn(
        2, MCFG.n_frames, MCFG.ctx_dim).astype(np.float32)
    with _Srv(CaptionServer(cap, port=0)) as s:
        st1, o1 = _post(s.port, "/caption",
                        encode_npz_request(feats), "application/x-npz")
        st2, o2 = _post(s.port, "/caption",
                        json.dumps({"features": feats.tolist()}),
                        "application/json")
    assert st1 == st2 == 200
    assert o1["captions"] == o2["captions"]
    assert o1["n"] == 2 and o1["ms"] > 0


def test_spatial_streams_over_the_wire(tmp_path):
    out, _, cfg = _artifact(tmp_path, spatial=True)
    cap = load_artifact(out)
    m = cfg.model
    rng = np.random.RandomState(2)
    feats = rng.randn(2, m.n_frames, m.ctx_dim).astype(np.float32)
    regs = rng.randn(2, m.n_frames, m.n_regions,
                     m.region_dim).astype(np.float32)
    with _Srv(CaptionServer(cap, port=0)) as s:
        served = request_captions("127.0.0.1", s.port, feats, regions=regs)
    assert served == cap.caption(feats, list(regs))


def test_health_manifest_and_errors(tmp_path):
    out, _, _ = _artifact(tmp_path)
    cap = load_artifact(out)
    with _Srv(CaptionServer(cap, port=0, manifest=cap.manifest)) as s:
        st, h = _get(s.port, "/healthz")
        assert (st, h["status"], h["mode"]) == (200, "ok", "aot")
        assert h["requests_served"] == 0
        st, man = _get(s.port, "/manifest")
        assert st == 200 and man["format"] == "stvd-aot-decode-v2"
        # bad content type
        st, err = _post(s.port, "/caption", b"x", "text/plain")
        assert st == 400 and "Content-Type" in err["error"]
        # missing features key
        st, err = _post(s.port, "/caption", json.dumps({"regions": [[1.0]]}),
                        "application/json")
        assert st == 400 and "features" in err["error"]
        # wrong rank
        st, err = _post(s.port, "/caption",
                        json.dumps({"features": [[1.0, 2.0]]}),
                        "application/json")
        assert st == 400 and "(N, F, D)" in err["error"]
        # unknown paths
        assert _get(s.port, "/nope")[0] == 404
        assert _post(s.port, "/nope", b"", "application/json")[0] == 404
        # counter advanced only on success
        feats = np.zeros((1, MCFG.n_frames, MCFG.ctx_dim), np.float32)
        request_captions("127.0.0.1", s.port, feats)
        assert _get(s.port, "/healthz")[1]["requests_served"] == 1


def test_live_captioner_binding_and_warmup():
    """CaptionServer binds any object with .caption (live Captioner
    included); warmup runs without error and returns wall seconds."""
    cfg = Config(model=MCFG, decode=DecodeConfig(beam_size=1, maxlen=8,
                                                 decode_batch=2))
    cap = Captioner(init_params(jax.random.PRNGKey(3), MCFG), cfg, _vocab())
    srv = CaptionServer(cap, port=0, mode="live")
    try:
        assert srv.warmup() > 0
        feats = np.random.RandomState(4).randn(
            3, MCFG.n_frames, MCFG.ctx_dim).astype(np.float32)
        with _Srv(srv) as s:
            served = request_captions("127.0.0.1", s.port, feats)
        assert served == cap.caption(feats)
    finally:
        pass


def test_build_server_requires_exactly_one_source(tmp_path):
    import argparse
    ns = argparse.Namespace(artifact=None, run_dir=None, params=None,
                            quant=None, host="127.0.0.1", port=0,
                            verbose=False)
    with pytest.raises(ValueError, match="exactly one"):
        build_server(ns)


def test_build_server_from_artifact_cli_args(tmp_path):
    out, _, _ = _artifact(tmp_path, beam=1)
    import argparse
    ns = argparse.Namespace(artifact=out, run_dir=None, params=None,
                            quant=None, host="127.0.0.1", port=0,
                            verbose=False)
    srv = build_server(ns)
    try:
        assert srv.mode == "aot"
        assert srv.manifest["batch_sizes"] == [3]
    finally:
        srv.server_close()


def test_nbest_endpoint_aot_and_live(tmp_path):
    """POST /nbest: aot mode (artifact exported with nbest) and live
    mode return identical ranked hypothesis lists; ?n= caps them;
    artifacts without nbest graphs 400."""
    import dataclasses as _dc

    from stvd.cli.serve import request_nbest

    cfg = Config(model=MCFG, decode=DecodeConfig(beam_size=3, maxlen=8,
                                                 decode_batch=2,
                                                 length_norm=0.6))
    params = init_params(jax.random.PRNGKey(9), MCFG)
    vocab = _vocab()
    out = str(tmp_path / "artifact")
    save_artifact(out, params, cfg, vocab, platforms=("cpu",), nbest=True)
    aot = load_artifact(out)
    live = Captioner(params, cfg, vocab)
    feats = np.random.RandomState(9).randn(
        3, MCFG.n_frames, MCFG.ctx_dim).astype(np.float32)

    with _Srv(CaptionServer(aot, port=0, manifest=aot.manifest)) as s:
        got_aot = request_nbest("127.0.0.1", s.port, feats, n=2)
    with _Srv(CaptionServer(live, port=0, mode="live")) as s:
        got_live = request_nbest("127.0.0.1", s.port, feats, n=2)
    assert [[t for t, _ in v] for v in got_aot] \
        == [[t for t, _ in v] for v in got_live]
    assert all(len(v) == 2 for v in got_aot)

    # artifact without nbest graphs -> 400 with a helpful message
    out2 = str(tmp_path / "plain")
    save_artifact(out2, params, cfg, vocab, platforms=("cpu",))
    with _Srv(CaptionServer(load_artifact(out2), port=0)) as s:
        st, err = _post(s.port, "/nbest",
                        json.dumps({"features": feats.tolist()}),
                        "application/json")
    assert st == 400 and "no n-best graphs" in err["error"]


def test_swap_params_endpoint(tmp_path):
    """POST /swap_params hot-swaps weights mid-run: served captions
    flip to the new model's output, no restart; disabled (403) without
    --allow-swap; bad path / wrong architecture are a 400."""
    out, params, cfg = _artifact(tmp_path)
    cap = load_artifact(out)
    feats = np.random.RandomState(0).randn(
        3, MCFG.n_frames, MCFG.ctx_dim).astype(np.float32)
    p2 = init_params(jax.random.PRNGKey(7), MCFG)
    swap_path = str(tmp_path / "weights2.npz")
    np.savez(swap_path, **{k: np.asarray(v) for k, v in p2.items()})
    want_new = load_artifact(out, params=p2).caption(feats)

    with _Srv(CaptionServer(cap, port=0, manifest=cap.manifest,
                            allow_swap=True)) as s:
        before = request_captions("127.0.0.1", s.port, feats)
        code, resp = _post(s.port, "/swap_params",
                           json.dumps({"path": swap_path}),
                           "application/json")
        assert code == 200 and resp["status"] == "swapped"
        after = request_captions("127.0.0.1", s.port, feats)
        code, resp = _post(s.port, "/swap_params",
                           json.dumps({"path": "/no/such.npz"}),
                           "application/json")
        assert code == 400
    assert after == want_new
    assert before == load_artifact(out).caption(feats)

    with _Srv(CaptionServer(cap, port=0)) as s:
        code, resp = _post(s.port, "/swap_params",
                           json.dumps({"path": swap_path}),
                           "application/json")
        assert code == 403


def test_swap_params_validates_architecture(tmp_path):
    out, params, cfg = _artifact(tmp_path)
    cap = load_artifact(out)
    import pytest
    bad = {k: np.asarray(v) for k, v in params.items()}
    bad.pop(sorted(bad)[0])
    with pytest.raises(ValueError, match="key mismatch"):
        cap.swap_params(bad)
    bad = {k: np.asarray(v) for k, v in params.items()}
    k0 = sorted(bad)[0]
    bad[k0] = np.zeros(np.asarray(bad[k0]).shape + (2,), np.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        cap.swap_params(bad)


def test_swap_params_live_captioner():
    from stvd.api import Captioner
    cfg = Config(model=MCFG, decode=DecodeConfig(beam_size=2, maxlen=8,
                                                 decode_batch=3))
    p1 = init_params(jax.random.PRNGKey(1), MCFG)
    p2 = init_params(jax.random.PRNGKey(2), MCFG)
    feats = np.random.RandomState(3).randn(
        3, MCFG.n_frames, MCFG.ctx_dim).astype(np.float32)
    cap = Captioner(p1, cfg, _vocab())
    want = Captioner(p2, cfg, _vocab()).caption(feats)
    cap.caption(feats)
    cap.swap_params({k: np.asarray(v) for k, v in p2.items()})
    assert cap.caption(feats) == want


def test_shutdown_endpoint(tmp_path):
    """POST /shutdown: 403 unless enabled; when enabled, replies then
    stops serve_forever (the signal-free exit for scripted benches)."""
    out, _, _ = _artifact(tmp_path, beam=1)
    cap = load_artifact(out)
    # disabled by default
    with _Srv(CaptionServer(cap, port=0)) as s:
        st, err = _post(s.port, "/shutdown", b"", "application/json")
        assert st == 403 and "allow-shutdown" in err["error"]
    # enabled: serve_forever returns on its own after the reply
    srv = CaptionServer(cap, port=0, allow_shutdown=True)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    st, obj = _post(srv.server_port, "/shutdown", b"", "application/json")
    assert st == 200 and obj["status"] == "shutting down"
    t.join(timeout=10)
    assert not t.is_alive()
    srv.server_close()


def test_data_parallel_artifact_through_daemon(tmp_path):
    """A data_parallel=4 artifact served over HTTP: handler-thread
    mesh calls work and captions match the single-device live path."""
    cfg = Config(model=MCFG, decode=DecodeConfig(beam_size=2, maxlen=8,
                                                 decode_batch=4))
    params = init_params(jax.random.PRNGKey(13), MCFG)
    vocab = _vocab()
    out = str(tmp_path / "artifact")
    save_artifact(out, params, cfg, vocab, platforms=("cpu",),
                  batch_sizes=(4,), data_parallel=4)
    aot = load_artifact(out)
    live = Captioner(params, cfg, vocab)
    feats = np.random.RandomState(13).randn(
        6, MCFG.n_frames, MCFG.ctx_dim).astype(np.float32)
    with _Srv(CaptionServer(aot, port=0, manifest=aot.manifest)) as s:
        served = request_captions("127.0.0.1", s.port, feats)
    assert served == live.caption(feats)


def test_raw_wire_format_matches_npz_and_errors(tmp_path):
    """application/x-stvd-raw (zero-copy parse): captions equal the npz
    wire; malformed raw bodies 400 with specific messages."""
    from stvd.cli.serve import encode_raw_request

    out, _, cfg = _artifact(tmp_path, spatial=True)
    cap = load_artifact(out)
    m = cfg.model
    rng = np.random.RandomState(21)
    feats = rng.randn(2, m.n_frames, m.ctx_dim).astype(np.float32)
    regs = rng.randn(2, m.n_frames, m.n_regions,
                     m.region_dim).astype(np.float32)
    with _Srv(CaptionServer(cap, port=0)) as s:
        raw = request_captions("127.0.0.1", s.port, feats, regions=regs,
                               wire="raw")
        npz = request_captions("127.0.0.1", s.port, feats, regions=regs,
                               wire="npz")
        assert raw == npz == cap.caption(feats, list(regs))

        # non-contiguous input still encodes correctly (F-order source)
        f_noncontig = np.asfortranarray(feats)
        assert request_captions("127.0.0.1", s.port, f_noncontig,
                                regions=regs, wire="raw") == raw

        # truncated body
        chunks = encode_raw_request(feats, regs)
        body = b"".join(bytes(c) for c in chunks)[:-100]
        st, err = _post(s.port, "/caption", body, "application/x-stvd-raw")
        assert st == 400 and "truncated" in err["error"]
        # unknown stream name
        bad_header = json.dumps(
            {"weights": [[2, 2], "float32"]}).encode()
        body = len(bad_header).to_bytes(4, "big") + bad_header + b"\0" * 16
        st, err = _post(s.port, "/caption", body, "application/x-stvd-raw")
        assert st == 400 and "unknown stream" in err["error"]
        # non-numeric dtype rejected before frombuffer
        bad_header = json.dumps(
            {"features": [[1, 1, 1], "object"]}).encode()
        body = len(bad_header).to_bytes(4, "big") + bad_header + b"\0" * 8
        st, err = _post(s.port, "/caption", body, "application/x-stvd-raw")
        assert st == 400 and "dtype" in err["error"]


def test_stats_endpoint(tmp_path):
    out, _, _ = _artifact(tmp_path, beam=1)
    cap = load_artifact(out)
    feats = np.zeros((2, MCFG.n_frames, MCFG.ctx_dim), np.float32)
    with _Srv(CaptionServer(cap, port=0)) as s:
        st, empty = _get(s.port, "/stats")
        assert st == 200 and empty == {"requests_served": 0}
        for _ in range(3):
            request_captions("127.0.0.1", s.port, feats)
        st, stats = _get(s.port, "/stats")
    assert stats["requests_served"] == 3
    c = stats["caption"]
    assert c["count"] == 3 and c["videos"] == 6
    assert 0 < c["min_ms"] <= c["p50_ms"] <= c["p95_ms"]


def test_raw_wire_rejects_nonpositive_dims(tmp_path):
    out, _, _ = _artifact(tmp_path, beam=1)
    cap = load_artifact(out)
    header = json.dumps({"features": [[-1, 6, 32], "float32"]}).encode()
    body = len(header).to_bytes(4, "big") + header + b"\0" * (6 * 32 * 4)
    with _Srv(CaptionServer(cap, port=0)) as s:
        st, err = _post(s.port, "/caption", body, "application/x-stvd-raw")
    assert st == 400 and "invalid shape" in err["error"]


def test_raw_wire_fuzz_never_500(tmp_path):
    """Malformed raw bodies must produce 400s (parse rejection), never
    500s or handler crashes: random prefixes, garbage headers, and
    truncations of a valid body."""
    out, _, _ = _artifact(tmp_path, beam=1)
    cap = load_artifact(out)
    from stvd.cli.serve import encode_raw_request
    feats = np.zeros((1, MCFG.n_frames, MCFG.ctx_dim), np.float32)
    valid = b"".join(bytes(c) for c in encode_raw_request(feats))
    rng = np.random.RandomState(0)
    bodies = [b"", b"\0", b"\xff" * 8, rng.bytes(64), rng.bytes(4096),
              valid[:3], valid[:20], valid[:-1],
              (len(valid) * 2).to_bytes(4, "big") + valid[4:]]
    with _Srv(CaptionServer(cap, port=0)) as s:
        for body in bodies:
            st, obj = _post(s.port, "/caption", body,
                            "application/x-stvd-raw")
            assert st == 400, (st, obj, body[:16])
        # the daemon still serves after the fuzz barrage
        assert request_captions("127.0.0.1", s.port, feats)


def test_quant_rejected_in_artifact_mode(tmp_path):
    out, _, _ = _artifact(tmp_path, beam=1)
    import argparse
    ns = argparse.Namespace(artifact=out, run_dir=None, params=None,
                            quant="int8", host="127.0.0.1", port=0,
                            verbose=False)
    with pytest.raises(ValueError, match="live mode only"):
        build_server(ns)


# ---- request coalescing (--coalesce-wait-ms) ------------------------------

class _StubCaptioner:
    """Counts device calls; captions encode (F, sum) so per-request
    result routing is checkable.  Raises for F == 7 when poisoned."""

    def __init__(self, poison_f=None):
        self.calls = []          # list of (n_videos, f_dim)
        self.poison_f = poison_f
        self._lock = threading.Lock()

    def caption(self, features, regions=None, motion=None):
        with self._lock:
            self.calls.append((len(features), features.shape[1]))
        if self.poison_f is not None and features.shape[1] == self.poison_f:
            raise ValueError("poisoned group")
        return [f"f{features.shape[1]}:{float(features[i].sum()):.0f}"
                for i in range(len(features))]

    # bank-resident surface (ids coalescing)
    def _rows_for(self, ids):
        bad = [v for v in ids if not v.startswith("vid")]
        if bad:
            raise ValueError(f"unknown video ids: {bad}")

    def caption_ids(self, ids):
        self._rows_for(ids)
        with self._lock:
            self.calls.append((len(ids), "ids"))
        return [f"id:{v}" for v in ids]


def _concurrent_requests(port, payloads):
    """POST each (features, regions) payload from its own thread via the
    raw wire; return results/errors in submission order."""
    results = [None] * len(payloads)
    barrier = threading.Barrier(len(payloads))

    def run(i, feats):
        barrier.wait()
        try:
            results[i] = request_captions("127.0.0.1", port, feats)
        except Exception as e:
            results[i] = e

    threads = [threading.Thread(target=run, args=(i, f))
               for i, f in enumerate(payloads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    return results


def test_coalescer_batches_concurrent_requests():
    """Concurrent b=1 requests inside the window ride ONE device call;
    every client still gets exactly its own caption."""
    from stvd.cli.serve import ThreadedCaptionServer

    stub = _StubCaptioner()
    srv = ThreadedCaptionServer(stub, port=0, coalesce_wait_ms=300.0)
    payloads = [np.full((1, 6, 8), float(i), np.float32) for i in range(4)]
    with _Srv(srv) as s:
        results = _concurrent_requests(s.port, payloads)
        _, stats = _get(s.port, "/stats")
    for i, got in enumerate(results):
        assert got == [f"f6:{float(payloads[i].sum()):.0f}"], (i, got)
    # 4 requests, fewer device calls, at least one genuinely batched
    assert sum(n for n, _ in stub.calls) == 4
    assert len(stub.calls) < 4
    assert max(n for n, _ in stub.calls) >= 2
    assert stats["coalesce"]["requests"] == 4
    assert stats["coalesce"]["max_requests_per_dispatch"] >= 2


def test_coalescer_groups_by_signature():
    """Different trailing shapes dispatch as separate device calls in
    the same window — never concatenated together."""
    from stvd.cli.serve import ThreadedCaptionServer

    stub = _StubCaptioner()
    srv = ThreadedCaptionServer(stub, port=0, coalesce_wait_ms=300.0)
    payloads = [np.full((1, 6, 8), 1.0, np.float32),
                np.full((1, 7, 8), 2.0, np.float32),
                np.full((1, 6, 8), 3.0, np.float32)]
    with _Srv(srv) as s:
        results = _concurrent_requests(s.port, payloads)
    assert results[0] == ["f6:48"] and results[2] == ["f6:144"]
    assert results[1] == ["f7:112"]
    for n, f in stub.calls:   # no call ever mixed F=6 with F=7
        assert f in (6, 7)
    assert sum(n for n, f in stub.calls if f == 6) == 2
    assert sum(n for n, f in stub.calls if f == 7) == 1


def test_coalescer_group_error_is_isolated():
    """A group that fails on device 500s only its own requests; other
    groups in the same window succeed and the daemon keeps serving."""
    from stvd.cli.serve import ThreadedCaptionServer

    stub = _StubCaptioner(poison_f=7)
    srv = ThreadedCaptionServer(stub, port=0, coalesce_wait_ms=300.0)
    good = np.full((1, 6, 8), 1.0, np.float32)
    bad = np.full((1, 7, 8), 2.0, np.float32)
    with _Srv(srv) as s:
        results = _concurrent_requests(s.port, [good, bad])
        # daemon alive and correct after the failed group
        again = request_captions("127.0.0.1", s.port, good)
    assert results[0] == ["f6:48"] == again
    assert isinstance(results[1], RuntimeError)
    assert "poisoned" in str(results[1])


def test_coalescer_batches_concurrent_id_requests():
    """Concurrent /caption_ids requests in the window ride ONE fused
    gather+decode dispatch; each client gets exactly its own captions,
    and an unknown id 400s its OWN requester pre-coalesce while peers
    in the same window succeed."""
    from stvd.cli.serve import ThreadedCaptionServer, request_caption_ids

    stub = _StubCaptioner()
    srv = ThreadedCaptionServer(stub, port=0, coalesce_wait_ms=300.0)
    payloads = [["vid0"], ["vid1", "vid2"], ["bogus"], ["vid3"]]
    results = [None] * len(payloads)
    barrier = threading.Barrier(len(payloads))

    def run(i, ids):
        barrier.wait()
        try:
            results[i] = request_caption_ids("127.0.0.1", srv_port, ids)
        except Exception as e:
            results[i] = e

    with _Srv(srv) as s:
        srv_port = s.port
        threads = [threading.Thread(target=run, args=(i, p))
                   for i, p in enumerate(payloads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        _, stats = _get(s.port, "/stats")
    assert results[0] == ["id:vid0"]
    assert results[1] == ["id:vid1", "id:vid2"]
    assert isinstance(results[2], RuntimeError)
    assert "400" in str(results[2]) and "bogus" in str(results[2])
    assert results[3] == ["id:vid3"]
    id_calls = [n for n, f in stub.calls if f == "ids"]
    assert sum(id_calls) == 4           # all valid ids served
    assert len(id_calls) < 3            # genuinely coalesced
    assert max(id_calls) >= 2
    assert stats["coalesce"]["videos"] >= 4


def test_build_server_coalesce_flag(tmp_path):
    """--coalesce-wait-ms > 0 selects the threaded server + coalescer;
    0 keeps the single-threaded server with no coalescer."""
    import argparse

    from stvd.cli.serve import ThreadedCaptionServer

    out, _, _ = _artifact(tmp_path, beam=1)
    for wait, want_threaded in ((250.0, True), (0.0, False)):
        ns = argparse.Namespace(artifact=out, run_dir=None, params=None,
                                quant=None, host="127.0.0.1", port=0,
                                verbose=False, coalesce_wait_ms=wait)
        srv = build_server(ns)
        try:
            assert isinstance(srv, ThreadedCaptionServer) == want_threaded
            assert (srv.coalescer is not None) == want_threaded
        finally:
            srv.server_close()


# ---- bank-resident serving (--bank / POST /caption_ids) --------------------

def _bank_file(tmp_path, spatial=False):
    ds = synthetic_dataset(n_videos=5, k=6, d=32,
                           n_regions=4 if spatial else 0, region_dim=16,
                           maxlen=8, seed=4)
    # full masks so the HTTP test can compare the id path against a
    # plain feature-payload request (which carries no mask);
    # true-ragged-mask exactness is pinned by the live-API test below
    ds.bank.frame_mask[:] = 1.0
    path = str(tmp_path / "bank.npz")
    ds.bank.save(path)
    return path, list(ds.bank.ids)


def test_caption_ids_matches_feature_request(tmp_path):
    """Id-addressed captions == feature-payload captions for the same
    resident videos (the gather is exact, not approximate)."""
    import argparse

    from stvd.cli.serve import request_caption_ids
    from stvd.data.bank import FeatureBank

    out, params, cfg = _artifact(tmp_path, beam=2)
    # a SPATIAL bank against a temporal artifact: _gather_ids must
    # filter to the model's streams (an AOT graph rejects extra pytree
    # keys — battery r4d caught this against the real msvd bank)
    bank_path, ids = _bank_file(tmp_path, spatial=True)
    ns = argparse.Namespace(artifact=out, run_dir=None, params=None,
                            quant=None, host="127.0.0.1", port=0,
                            verbose=False, coalesce_wait_ms=0.0,
                            bank=bank_path)
    srv = build_server(ns)
    assert srv.manifest["bank_videos"] == 5
    assert srv.manifest["bank_ids"] == ids
    bank = FeatureBank.load(bank_path)
    with _Srv(srv) as s:
        got = request_caption_ids("127.0.0.1", s.port, [ids[2], ids[0]])
        ref = request_captions("127.0.0.1", s.port,
                               bank.frames[[2, 0]].astype(np.float32))
    assert got == ref and len(got) == 2


def test_caption_ids_unknown_id_is_400(tmp_path):
    import argparse

    from stvd.cli.serve import request_caption_ids

    out, _, _ = _artifact(tmp_path, beam=1)
    bank_path, ids = _bank_file(tmp_path)
    ns = argparse.Namespace(artifact=out, run_dir=None, params=None,
                            quant=None, host="127.0.0.1", port=0,
                            verbose=False, coalesce_wait_ms=0.0,
                            bank=bank_path)
    with _Srv(build_server(ns)) as s:
        with pytest.raises(RuntimeError, match="unknown video ids"):
            request_caption_ids("127.0.0.1", s.port, ["nope"])
        # daemon still serves after the rejected request
        assert request_caption_ids("127.0.0.1", s.port, [ids[0]])


def test_caption_ids_without_bank_is_400(tmp_path):
    import argparse

    from stvd.cli.serve import request_caption_ids

    out, _, _ = _artifact(tmp_path, beam=1)
    ns = argparse.Namespace(artifact=out, run_dir=None, params=None,
                            quant=None, host="127.0.0.1", port=0,
                            verbose=False, coalesce_wait_ms=0.0, bank=None)
    with _Srv(build_server(ns)) as s:
        with pytest.raises(RuntimeError, match="no feature bank"):
            request_caption_ids("127.0.0.1", s.port, ["v0"])


def test_caption_ids_chunking_and_bucket_routing(tmp_path):
    """The FUSED gather+decode ids path (one dispatch per chunk) is
    exact across chunk boundaries: live Captioner with a ragged
    remainder (6 ids over decode_batch=4 -> one padded chunk), and a
    bucketed artifact (sizes 2,4) where 5 ids split bulk-4 + rem-1
    routed to the b=2 graph."""
    from stvd.data.batching import synthetic_dataset as synth

    ds = synth(n_videos=6, k=6, d=32, maxlen=8, seed=11)
    cfg = Config(model=MCFG, decode=DecodeConfig(beam_size=2, maxlen=8,
                                                 decode_batch=4))
    params = init_params(jax.random.PRNGKey(5), MCFG)
    cap = Captioner(params, cfg, _vocab())
    cap.attach_bank(ds.bank)
    ids = cap.bank_ids
    order = [5, 0, 3, 1, 4, 2]
    got = cap.caption_ids([ids[i] for i in order])
    dev = ds.bank.to_device(dtype=np.float32)
    ref = cap.caption_batch({k: np.asarray(v)[order]
                             for k, v in dev.items()})
    assert got == ref and len(got) == 6

    out = str(tmp_path / "bucketed")
    save_artifact(out, params, cfg, _vocab(), platforms=("cpu",),
                  batch_sizes=(2, 4))
    exp = load_artifact(out)
    exp.attach_bank(ds.bank)
    got = exp.caption_ids([ids[i] for i in order[:5]])
    ref = exp.caption_batch({k: np.asarray(v)[order[:5]]
                             for k, v in dev.items()})
    assert got == ref and len(got) == 5


def test_live_captioner_caption_ids():
    """The live Captioner's BankResident path works standalone (API
    surface, no HTTP): ids -> captions equal to raw-feature calls."""
    from stvd.data.batching import synthetic_dataset as synth

    ds = synth(n_videos=4, k=6, d=32, maxlen=8, seed=9)
    cfg = Config(model=MCFG, decode=DecodeConfig(beam_size=2, maxlen=8,
                                                 decode_batch=4))
    params = init_params(jax.random.PRNGKey(3), MCFG)
    cap = Captioner(params, cfg, _vocab())
    n = cap.attach_bank(ds.bank)
    assert n == 4
    ids = cap.bank_ids
    got = cap.caption_ids([ids[3], ids[1]])
    # exact-contract reference: host-gathered bank rows INCLUDING the
    # bank's true (possibly ragged) frame masks — the id path must
    # reproduce them exactly
    dev = ds.bank.to_device(dtype=np.float32)
    ref = cap.caption_batch({k: np.asarray(v)[[3, 1]]
                             for k, v in dev.items()})
    assert got == ref

