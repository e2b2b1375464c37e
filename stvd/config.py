"""Configuration for the stvd framework.

Frozen dataclasses mirroring the reference's Jobman-``DD`` option keys
(reference: ``config.py`` + ``model_attention.py:§validate_options`` — see
SURVEY.md §5 "Config / flag system"), so that reference recipes translate
1:1.  Unlike the reference's mutable dict, configs here are immutable and
hashable, which lets them ride through ``jax.jit`` as static arguments.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters.

    Mirrors the reference option keys (``dim_word``, ``dim``, ``ctx_dim``,
    ``n_words`` ... — reference ``config.py``); defaults follow SURVEY.md §5.
    """

    n_words: int = 13010            # vocab size (MSVD ~13k; reference caps at 20k)
    dim_word: int = 468             # word-embedding dim
    dim: int = 512                  # LSTM hidden dim (reference default ≈3518)
    ctx_dim: int = 1024             # frame-feature dim (GoogLeNet pool5)
    n_frames: int = 28              # K: frames per video after subsampling
    # --- spatial attention (the tuyunbin addition; reference
    #     model_attention.py:§lstm_cond_layer spatial stage) ---
    use_spatial: bool = False       # enable region-level spatial attention
    n_regions: int = 49             # R: regions per frame (7x7 conv grid)
    region_dim: int = 1024          # Dr: region-feature dim
    # --- dual-stream fusion (MSR-VTT: ResNet appearance + C3D motion) ---
    use_motion: bool = False        # enable second (motion) feature stream
    motion_dim: int = 2048          # C3D/motion feature dim
    # --- structure knobs (reference option names) ---
    encoder: str = "none"           # 'none' (reference default) | 'lstm':
    # frame-level LSTM over the K frames before attention (upstream
    # arctic-capgen option; residual into the context)
    selector: bool = True           # gating scalar beta on the context vector
    use_dropout: bool = True        # dropout before the logit projection
    dropout_rate: float = 0.5
    prev_word_logit: bool = True    # ff_logit_prev: add prev-word emb to logit
    alpha_c: float = 0.0            # attention-entropy regularizer weight
    # --- numerics ---
    param_dtype: str = "float32"    # parameter storage dtype
    compute_dtype: str = "bfloat16"  # activation dtype inside matmuls
    scan_unroll: int = 1            # train-scan unroll factor: batches the
    # backward wgrad-accumulator round-trips; costs compile time, so
    # default 1
    decode_quant: str = "none"      # 'none' | 'int8': W8A8 dynamic
    # quantization of the decode gates matmul (the compute-bound bulk of
    # the beam-decode step) on the int8 tensor cores — opt-in
    # quality/perf tradeoff; weights quantized once per decode program,
    # activations per step per row.  Training is never quantized.
    fused_seq_grad: bool = True     # hand-derived sequence VJP for the
    # teacher-forced train scan (model/seqgrad.py): weight grads become
    # two post-scan GEMMs instead of a 220 MB fp32 accumulator carried
    # through every backward step.  Exact-parity tested vs autodiff;
    # covers the temporal AND (since round 3) spatial paths; auto-
    # falls-back only for scheduled sampling (ss_prob > 0), whose
    # sampled inputs need the live scan
    wgrad_dtype: str = "float32"    # weight-gradient scan-accumulator
    # dtype: 'float32' (exact) or 'bfloat16' (halves the 220 MB/step
    # dL/d[gates] accumulator traffic — see step._dot_bf16_wgrad).
    spatial_wgrad_dtype: str = "bfloat16"  # dtype of the spatial fused
    # VJP's pregion-cotangent accumulator (the (B,K,R,s) = 360 MB f32
    # carry read+written every backward step — the single largest cost
    # of config-2 training).  bfloat16 halves that traffic at ~1e-2
    # relative wgrad error on Ws_att/bs_att only, which adadelta's
    # per-coordinate normalization absorbs.  float32 = exact (used
    # automatically whenever compute_dtype is float32).
    beam_gather: str = "flat"       # beam-search parent-state reorder
    # lowering (decode/beam.py): 'flat' = row gather from the
    # (B*k, dim) 2-D view with flattened b*k+parent indices
    # (production default); 'take' = take_along_axis on the (B, k, dim)
    # 3-D view; 'onehot' = einsum against a one-hot(parent) permutation
    # matrix (a matmul instead of a gather; exact — each output row
    # is 1.0*x + 0.0*rest in f32).  All three are token/score-exact
    # (pinned in tests/test_decode.py).
    beam_buf: str = "reorder"       # beam token bookkeeping scheme
    # (decode/beam.py): 'reorder' carries the (B, k, maxlen) prefix
    # buffer and gathers it by parent each step; 'backptr' writes only
    # (word, parent) at position t and reconstructs prefixes once after
    # the loop by backtracking.  Token/score-exact either way (pinned).
    remat: bool = False             # jax.checkpoint the train-scan body:
    # recompute per-step activations in the backward instead of saving
    # them.  A memory lever for the autodiff train path (fused_seq_grad
    # off, or scheduled sampling), whose saved spatial tanh alone is
    # (B,K,R,s) x 30 steps = 40 GB at config-2 scale, batch 64.

    @property
    def attn_dim(self) -> int:
        """Projection width of the temporal-attention MLP (== ctx_dim in
        the reference: Wc_att is (ctx_dim, ctx_dim))."""
        return self.ctx_dim


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training-loop hyperparameters (reference ``config.py`` keys)."""

    batch_size: int = 64
    valid_batch_size: int = 200
    maxlen: int = 30                # max caption length (tokens incl. EOS)
    optimizer: str = "adadelta"     # adadelta | rmsprop | sgd | adam
    lr: float = 1.0                 # adadelta is lr-insensitive (reference lr≈1e-4..1e-2 w/ scaling)
    clip_c: float = 10.0            # global-norm gradient clip
    patience: int = 20              # early-stop patience (validation rounds)
    max_epochs: int = 500
    disp_freq: int = 10             # print cost every N updates
    sample_freq: int = 200          # sample captions every N updates
    valid_freq: int = 2000          # validate every N updates
    save_freq: int = 2000           # checkpoint every N updates
    metric: str = "meteor"          # early-stop metric: meteor|bleu4|cider|
    # rouge|nll ('blue' accepted as the reference's spelling of bleu4)
    length_buckets: str = ""        # e.g. "10,20,30": length-bucketed
    # train batches with a few STATIC (B, T_bucket) shapes — the compute
    # equivalent of the reference's HomogeneousData (SURVEY.md §2 row
    # 5).  Real captions average ~7 tokens vs maxlen 30; bucketing
    # recovers the pad-step FLOPs the scan otherwise wastes.  Empty =
    # off (every batch at maxlen).  maxlen is appended automatically if
    # no bucket covers it.  Stored as a comma string (not a tuple) so
    # the frozen config stays hashable AND JSON-round-trippable.
    opt_slot_dtype: str = "float32"  # adadelta accumulator (acc /
    # acc_delta) storage dtype: float32 | bfloat16.  The optimizer
    # update is pure memory streaming (~3.0 GB per step at reference
    # scale); bf16 slots cut that to ~2.0 GB.  Update math stays f32
    # (slots are cast in, rounded out); f32 = exact reference parity
    # (default).
    meteor_profile: str = "meteor2005"  # METEOR parameter profile used in
    # validation scoring: meteor2005 | meteor15-en (metrics/meteor.py)
    grad_accum: int = 1             # microbatches per optimizer step:
    # the train scan runs grad_accum sequential microbatches of
    # batch_size/grad_accum rows, summing gradients of the SUMMED
    # objective (loss_terms numerators) before one exact weighted-mean
    # divide + update — same math as the full batch (pinned in
    # tests/test_train.py), but per-step activation memory shrinks by
    # the factor.  The memory alternative to model.remat that pays
    # serial microbatch latency instead of backward recompute.
    # Single-device only (DP shards the batch across chips instead).
    ss_prob: float = 0.0            # scheduled-sampling probability
    seed: int = 1234
    reload_: bool = False           # resume from save_dir checkpoint
    save_dir: str = "runs/default"
    tensorboard: bool = False       # also write TB scalar curves to
    # save_dir/tb (flax SummaryWriter); JSONL stays the primary record
    profile_dir: str = ""           # when set: capture a jax.profiler
    # device trace (Perfetto/TensorBoard-viewable) of train updates
    # [profile_start, profile_start + profile_steps) into this dir
    profile_start: int = 5          # first traced update (post-compile)
    profile_steps: int = 5          # traced-update count
    # --- parallelism (no reference equivalent; SURVEY.md §2 rows 9-10) ---
    data_parallel: bool = False     # shard batch over the 'data' mesh
    # axis.  Off by default (single-device runs stay mesh-free); the
    # msvd-dp preset and the MSVD/MSR-VTT recipes turn it on, and
    # cli/train honors it unless --[no-]data-parallel overrides.
    use_shard_map: bool = False     # explicit lax.psum collectives under
    # shard_map instead of XLA sharding propagation (both paths produce
    # bit-identical updates; see train/loop.py:_make_shard_map_train_step)
    per_device_batch: int = 0       # when >0, global batch_size is scaled
    # to per_device_batch * DATA-axis size at fit() time (DP recipes stay
    # valid across device counts)
    model_parallel: int = 1         # >1: tensor parallelism — a 2-D
    # (data x model) mesh; gates/input GEMM weights row-sharded, vocab
    # logits column-sharded per train/parallel.py:TP_RULES. Requires
    # data_parallel (the mesh owns all devices; data axis may be 1).
    donate_state: bool = True       # donate train-state buffers to jit
    # --- debugging (reference common.py:§grad_nan_report equivalent) ---
    debug_nans: bool = False        # raise on first NaN-producing op


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    """Decoding hyperparameters (reference ``gen_sample`` args)."""

    beam_size: int = 5              # reference k=5; 1 == greedy
    maxlen: int = 30
    length_norm: float = 0.6        # GNMT-style length-norm alpha (0 = off);
    # reference normalizes by plain length when `normalize=True`
    decode_batch: int = 64


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset paths and shapes (reference ``config.py`` dataset keys)."""

    dataset: str = "synthetic"      # synthetic | youtube2text (MSVD) | msrvtt
    data_dir: str = "data"
    feature_file: Optional[str] = None   # packed .npz bank (see data/bank.py)
    region_feature_file: Optional[str] = None
    motion_feature_file: Optional[str] = None
    vocab_file: Optional[str] = None
    captions_file: Optional[str] = None
    # synthetic-dataset knobs (tests / benchmarking without real features)
    synthetic_videos: int = 64
    synthetic_captions_per_video: int = 2


# kernel switches that older run directories' config.json still carry;
# the kernels are gone, so loading drops them
_REMOVED_MODEL_KEYS = frozenset({"spatial_bwd_kernel", "train_fwd_kernel",
                                 "train_tail_kernel", "gates_kernel"})


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    decode: DecodeConfig = dataclasses.field(default_factory=DecodeConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "Config":
        d = json.loads(s)
        model = {k: v for k, v in d.get("model", {}).items()
                 if k not in _REMOVED_MODEL_KEYS}
        return Config(
            model=ModelConfig(**model),
            train=TrainConfig(**d.get("train", {})),
            decode=DecodeConfig(**d.get("decode", {})),
            data=DataConfig(**d.get("data", {})),
        )


def validate(cfg: Config) -> Config:
    """Sanity-check a config (reference: model_attention.py:§validate_options)."""
    m = cfg.model
    if m.n_words < 4:
        raise ValueError("n_words must be >= 4 (eos/unk/bos + >=1 real word)")
    if m.use_spatial and m.n_regions < 1:
        raise ValueError("use_spatial requires n_regions >= 1")
    if cfg.decode.beam_size < 1:
        raise ValueError("beam_size must be >= 1")
    if cfg.train.optimizer not in ("adadelta", "rmsprop", "sgd", "adam"):
        raise ValueError(f"unknown optimizer {cfg.train.optimizer!r}")
    if cfg.train.opt_slot_dtype not in ("float32", "bfloat16"):
        raise ValueError(
            f"unknown opt_slot_dtype {cfg.train.opt_slot_dtype!r}")
    if (cfg.train.opt_slot_dtype == "bfloat16"
            and cfg.train.optimizer != "adadelta"):
        raise ValueError("opt_slot_dtype=bfloat16 is implemented for "
                         "the adadelta optimizer only")
    if m.encoder not in ("none", "lstm"):
        raise ValueError(f"unknown encoder {m.encoder!r}")
    if m.decode_quant not in ("none", "int8"):
        raise ValueError(f"unknown decode_quant {m.decode_quant!r}")
    from .metrics.meteor import PROFILES
    if cfg.train.meteor_profile not in PROFILES:
        raise ValueError(f"unknown meteor_profile "
                         f"{cfg.train.meteor_profile!r}; "
                         f"available: {sorted(PROFILES)}")
    if m.wgrad_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown wgrad_dtype {m.wgrad_dtype!r}")
    if m.spatial_wgrad_dtype not in ("float32", "bfloat16"):
        raise ValueError(
            f"unknown spatial_wgrad_dtype {m.spatial_wgrad_dtype!r}")
    if m.beam_gather not in ("take", "flat", "onehot"):
        raise ValueError(f"unknown beam_gather {m.beam_gather!r}")
    if m.beam_buf not in ("reorder", "backptr"):
        raise ValueError(f"unknown beam_buf {m.beam_buf!r}")
    if not 0.0 <= cfg.train.ss_prob <= 1.0:
        raise ValueError("ss_prob must be in [0, 1]")
    if cfg.train.grad_accum < 1:
        raise ValueError("grad_accum must be >= 1")
    if cfg.train.batch_size % cfg.train.grad_accum:
        raise ValueError(
            f"batch_size {cfg.train.batch_size} must be divisible by "
            f"grad_accum {cfg.train.grad_accum} (static microbatch shapes)")
    if cfg.train.grad_accum > 1 and (cfg.train.data_parallel
                                     or cfg.train.model_parallel > 1):
        raise ValueError("grad_accum is the single-device memory lever; "
                         "with a mesh, shard the batch instead")
    if cfg.train.model_parallel < 1:
        raise ValueError("model_parallel must be >= 1")
    if cfg.train.model_parallel > 1 and cfg.train.use_shard_map:
        raise ValueError("use_shard_map is the explicit DP path; "
                         "model_parallel > 1 uses pjit shardings")
    if cfg.train.length_buckets:
        try:
            bs = parse_buckets(cfg.train.length_buckets)
        except ValueError:
            raise ValueError(
                f"length_buckets must be comma-separated ints, got "
                f"{cfg.train.length_buckets!r}")
        if not bs:
            # ',' / ' ' parse to an empty tuple; fail here with the key
            # name instead of an opaque max()-of-empty inside fit()
            raise ValueError(
                f"length_buckets is non-empty but parses to no buckets: "
                f"{cfg.train.length_buckets!r}")
        if any(b < 1 for b in bs):
            raise ValueError("length_buckets entries must be >= 1")
    return cfg


def parse_buckets(spec: str) -> tuple:
    """'10,20,30' -> (10, 20, 30)."""
    return tuple(int(x) for x in spec.split(",") if x.strip())


# Named presets mirroring the five BASELINE.json target configs.
#
# Presets carry REFERENCE-SCALE dims (the BASELINE.json benchmark
# shapes): the reference's dim≈3518 is rounded up to 3584 (28×128, tile
# aligned), dim_word 468→512, MSVD vocab ~13k→13056 (102×128), K=28
# frames, maxlen 30, beam 5 — so `preset(N)` IS the BASELINE config,
# not a toy.  Tests use explicitly small ModelConfigs instead.
_REF_MODEL = dict(n_words=13056, dim_word=512, dim=3584, ctx_dim=1024,
                  n_frames=28, compute_dtype="bfloat16", scan_unroll=1)
# scan_unroll=1: with the fused sequence VJP (model/seqgrad.py) there is
# no per-step wgrad accumulator left to batch


def preset(name: str) -> Config:
    """Return a named config preset.

    Presets 1-5 correspond to BASELINE.json targets:
      msvd-temporal   (1) temporal attention, MSVD GoogLeNet features, greedy
      msvd-spatial    (2) full spatial-temporal attention
      msvd-beam       (3) beam=5 + length norm, batched on-device
      msrvtt-fused    (4) MSR-VTT, ResNet appearance + C3D motion streams
      msvd-dp         (5) data-parallel training (explicit shard_map
                          psum path, per-device batch scaling)
    """
    base = Config()
    model = dataclasses.replace(base.model, **_REF_MODEL)
    decode = dataclasses.replace(base.decode, beam_size=5, maxlen=30,
                                 length_norm=0.6, decode_batch=256)
    # data.dataset stays 'synthetic' so presets run anywhere; the MSVD /
    # MSR-VTT file paths live in recipes/*.json which set dataset + paths
    base = base.replace(model=model, decode=decode)
    if name in ("msvd-temporal", "1"):
        return base.replace(
            decode=dataclasses.replace(base.decode, beam_size=1,
                                       decode_batch=1024))
    if name in ("msvd-spatial", "2"):
        return base.replace(
            model=dataclasses.replace(base.model, use_spatial=True,
                                      n_regions=49, region_dim=1024))
    if name in ("msvd-beam", "3"):
        return base
    if name in ("msrvtt-fused", "4"):
        return base.replace(
            model=dataclasses.replace(
                base.model, use_motion=True, motion_dim=2048,
                ctx_dim=2048, n_words=20096),
            data=dataclasses.replace(base.data, dataset="msrvtt"))
    if name in ("msvd-dp", "5"):
        return base.replace(
            train=dataclasses.replace(base.train, data_parallel=True,
                                      use_shard_map=True,
                                      per_device_batch=64))
    raise KeyError(f"unknown preset {name!r}")
