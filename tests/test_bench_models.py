"""Analytic cost-model sanity (bench.py decode/train models).

These are the FLOP and byte counts behind the roofline and MFU fields of
bench.py's records — they must track config dims (spatial/motion terms)
so every preset's "how far from floor?" question is answerable from the
repo."""

import importlib.util
import sys


def _bench():
    spec = importlib.util.spec_from_file_location("bench", "bench.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules.setdefault("bench", mod)
    spec.loader.exec_module(mod)
    return mod


H100 = "NVIDIA H100 80GB HBM3"


def test_decode_cost_model_spatial_terms():
    bench = _bench()
    from stvd.config import preset
    m3 = preset("3").model
    m2 = preset("2").model
    a = bench.decode_cost_model(m3, 256, 5)
    b = bench.decode_cost_model(m2, 256, 5)
    # spatial adds matmul work and bytes on every step
    assert b["flops"] > a["flops"] and b["bytes"] > a["bytes"]
    # the region stage's (B, K, R, s) reads dominate the added bytes
    r, s, k = m2.n_regions, m2.region_dim, m2.n_frames
    assert b["bytes"] - a["bytes"] > 256 * k * r * s * 6


def test_decode_cost_model_motion_dims():
    bench = _bench()
    from stvd.config import preset
    m3 = preset("3").model
    m4 = preset("4").model
    a = bench.decode_cost_model(m3, 256, 5)
    b = bench.decode_cost_model(m4, 256, 5)
    # motion costs nothing per step directly, but ctx 2048 / vocab 20k
    # raise the FLOP count
    assert b["flops"] > a["flops"]


def test_train_cost_model_monotone():
    bench = _bench()
    from stvd.config import preset
    m3 = preset("3").model
    m2 = preset("2").model
    m4 = preset("4").model
    f3 = bench.train_cost_model(m3, 64, 30)
    f2 = bench.train_cost_model(m2, 64, 30)
    f4 = bench.train_cost_model(m4, 64, 30)
    assert f2 > f3          # spatial terms (incl. 184-GFLOP pregion GEMM)
    assert f4 > f3          # ctx 2048 + vocab 20k + fusion matmuls
    # the spatial pregion GEMM alone is ~184 GFLOP at reference scale;
    # fwd delta must exceed it (x3 for the train total)
    assert f2 - f3 > 3 * 150e9


def test_roofline_fields_well_formed():
    """Shares come from the peak table of the measured device_kind; a
    device not in the table gets no share (never an assumed peak)."""
    bench = _bench()
    pk = bench.PEAKS[H100]
    cost = {"flops": pk["bf16_flops"] * 2e-3, "int8_ops": 0,
            "bytes": pk["hbm_bytes"] * 1e-3}
    r = bench.roofline(cost, 4e-3, H100)
    assert r["bound"] == "compute"
    assert abs(r["floor_s"] - 2e-3) < 1e-12 and r["share"] == 0.5
    assert bench.roofline(cost, 4e-3, "NVIDIA A100-SXM4-80GB") is None
    assert bench.roofline(cost, 4e-3, "cpu") is None
    # int8 ops run at the int8 rate, not the bf16 one
    q = bench.roofline({"flops": 0, "int8_ops": pk["int8_ops"] * 1e-3,
                        "bytes": 0}, 2e-3, H100)
    assert abs(q["floor_s"] - 1e-3) < 1e-12


def test_latency_floor_is_weight_streaming_bound():
    """At b=1 the decode floor on an H100 is memory, not compute: the
    ~145 MB gates weight stack is streamed every step for 5 rows of
    work."""
    bench = _bench()
    mcfg, _, _ = bench._cfgs(False)
    cost = bench.decode_cost_model(mcfg, 1, 5)
    assert bench.roofline(cost, 1.0, H100)["bound"] == "memory"
    # at batch 384 x beam 5 the gates matmul makes it compute-bound
    big = bench.decode_cost_model(mcfg, 384, 5)
    assert bench.roofline(big, 1.0, H100)["bound"] == "compute"


def test_bench_latency_smoke():
    """bench_latency end-to-end at toy scale: keys + positive values; on
    a device without a peak-table entry no floor or share is invented."""
    bench = _bench()
    out = bench.bench_latency(False, chain_iters=2, synced_iters=2,
                              small=True)
    assert out["metric"] == "decode_latency_ms_b1_beam5"
    assert out["value"] > 0 and out["client_p50_ms"] > 0
    assert out["floor_ms"] is None and out["roofline_share"] is None


def test_greedy_tail_cost_below_beam():
    """Greedy (beam 1) does a fifth of beam-5's per-step matmul work at
    the same videos; the weights it streams are the same."""
    bench = _bench()
    mcfg, _, _ = bench._cfgs(False)
    g = bench.decode_cost_model(mcfg, 64, 1)
    b = bench.decode_cost_model(mcfg, 64, 5)
    assert 4.5 * g["flops"] < b["flops"] < 5.5 * g["flops"]
    assert g["bytes"] < b["bytes"]


def test_int8_cost_moves_gates_to_int8_ops():
    bench = _bench()
    mcfg, _, _ = bench._cfgs(False)
    f = bench.decode_cost_model(mcfg, 64, 5)
    q = bench.decode_cost_model(mcfg, 64, 5, quant="int8")
    assert f["int8_ops"] == 0 and q["int8_ops"] > 0
    assert q["flops"] + q["int8_ops"] == f["flops"]
    assert q["bytes"] < f["bytes"]          # int8 weight stack


def test_main_refuses_without_gpu(capsys):
    """A measurement path that finds no GPU fails; it never reports a
    CPU number under a device metric."""
    bench = _bench()
    assert bench.main(["--small"]) == 2
    assert capsys.readouterr().out == ""


def test_bench_decode_trained_bank_dims_guard(tmp_path, capsys):
    """bench_decode_trained must NOT feed a default bank whose dims
    belong to a different config (the repo-root data/msvd bank is
    reference-scale; a small run dir must fall back to synthetic
    features instead of wrong-shaped rows), and the natural-EOS /
    worst-case pair must come out ordered."""
    import numpy as np

    from stvd.cli.train import main as train_main
    from stvd.data.bank import FeatureBank

    d = str(tmp_path / "run")
    rc = train_main([
        "--preset", "msvd-beam",
        "--set", "model.dim=48", "--set", "model.ctx_dim=32",
        "--set", "model.n_frames=5", "--set", "model.n_words=48",
        "--set", "model.dim_word=24",
        "--set", "data.synthetic_videos=6",
        "--set", "train.batch_size=6", "--set", "train.valid_freq=0",
        "--set", "train.sample_freq=0",
        "--set", f"train.save_dir={d}", "--max-updates", "4",
    ])
    assert rc == 0
    bench = _bench()

    # mismatched bank on disk: dims of a DIFFERENT config
    bad = FeatureBank(ids=["v0"], frames=np.zeros((1, 9, 77), "f"),
                      frame_mask=np.ones((1, 9), "f"))
    bad_path = str(tmp_path / "bad_bank.npz")
    bad.save(bad_path)
    out = bench.bench_decode_trained(d, iters=1, batch=4,
                                     bank_path=bad_path)
    assert out["features"] == "synthetic"      # guard engaged
    assert out["value"] > 0
    assert out["captions_per_sec_eos_suppressed"] > 0
    assert 0 < out["mean_caption_len"] <= out["maxlen"]
    assert out["quant"] == "bf16"

    # greedy mode: same harness through greedy_decode (config-1 path)
    g = bench.bench_decode_trained(d, iters=1, batch=4,
                                   bank_path=bad_path, mode="greedy")
    assert g["mode"] == "greedy" and g["beam"] == 1
    assert g["value"] > 0
    assert 0 < g["mean_caption_len"] <= g["maxlen"]
