"""The training driver (L4): optimizers, jitted train step, validation,
checkpointing, early stopping.

Reference: ``model_attention.py:§train`` + ``common.py`` optimizer
factories (SURVEY.md §3.1).  Differences:

  * ONE jitted, donated train step (forward+backward+update fused by
    XLA) instead of the reference's separate f_grad_shared/f_update
    host round-trips,
  * optimizers are optax transforms (adadelta default, like the
    reference; rmsprop/sgd/adam available) with global-norm clipping
    (reference ``clip_c``),
  * data parallelism by construction: params replicated, batch sharded
    on the mesh data axis; XLA emits the psum (SURVEY.md §2 row 10),
  * checkpointing of params + optimizer state + step + rng +
    best-metric record (the reference saves params only and silently
    resets adadelta accumulators on reload — SURVEY.md §5).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..config import Config, ModelConfig, TrainConfig
from ..data.batching import BatchIterator, Dataset, gather_batch
from ..model.decoder import StepFn, init_params
from ..utils.logging import MetricsLogger
from . import parallel
from .evaluate import evaluate_split
from .loss import loss_fn

TrainState = Dict[str, Any]   # {"params", "opt_state", "step", "rng"}


def _adadelta_slot_dtype(lr: float, slot_dtype, rho: float = 0.9,
                         eps: float = 1e-6) -> optax.GradientTransformation:
    """optax.adadelta's exact math with the two accumulator slots
    STORED in ``slot_dtype`` (update math stays f32: slots are cast in,
    rounded out).

    Why: the optimizer update is pure memory streaming — about 3.0 GB
    of traffic per step at 101 M params, bandwidth-bound rather than
    leaf-bound.  bf16 slots cut the traffic to ~2.0 GB.  With slot_dtype=float32 this is bit-exact vs
    optax.adadelta (pinned in tests/test_train.py)."""
    f32 = jnp.float32

    def init(params):
        z = lambda p: jnp.zeros(p.shape, slot_dtype)
        return (jax.tree.map(z, params), jax.tree.map(z, params))

    def update(grads, state, params=None):
        del params
        acc, acc_d = state

        def upd(g, a, d):
            g = g.astype(f32)
            # op order/associativity matches optax bit-exactly:
            # (1-rho)*(g*g) not ((1-rho)*g)*g; ratio-then-multiply for u
            a2 = rho * a.astype(f32) + (1 - rho) * (g * g)
            u = (jnp.sqrt(d.astype(f32) + eps) / jnp.sqrt(a2 + eps)) * g
            d2 = rho * d.astype(f32) + (1 - rho) * (u * u)
            return -lr * u, a2.astype(slot_dtype), d2.astype(slot_dtype)

        out = jax.tree.map(upd, grads, acc, acc_d)
        pick = lambda i: jax.tree.map(
            lambda t: t[i], out, is_leaf=lambda t: isinstance(t, tuple))
        return pick(0), (pick(1), pick(2))

    return optax.GradientTransformation(init, update)


def graves_rmsprop(step_size: float = 1e-4, momentum: float = 0.9,
                   decay: float = 0.95, eps: float = 1e-4,
                   slot_dtype=None) -> optax.GradientTransformation:
    """The reference's rmsprop (``common.py:§rmsprop``): the Graves-2013
    CENTERED variant with heavy-ball momentum — NOT ``optax.rmsprop``
    (uncentered, no momentum by default, decay 0.9, eps 1e-8).

    Reference update equations, per parameter (op order matched):

        rg   <- 0.95*rg  + 0.05*g          (running mean of g)
        rg2  <- 0.95*rg2 + 0.05*g^2        (running mean of g^2)
        ud   <- 0.9*ud - (1e-4*g)/sqrt(rg2 - rg^2 + 1e-4)
        p    <- p + ud

    using the POST-update rg/rg2 (the reference's ``f_grad_shared``
    writes the accumulators, then ``f_update`` reads the shared vars).
    NOTE the reference quirk, honored here for trajectory fidelity:
    ``f_update(lr)`` declares lr as input but never uses it
    (``on_unused_input='ignore'``) — the 1e-4 step size is HARDCODED,
    so a reference recipe's configured lr does not change rmsprop
    trajectories.  Pinned against a NumPy transcription of the update
    equations in tests/test_train.py.

    ``slot_dtype`` (default f32) stores the three slots like the
    adadelta bf16-slot variant above; math is always f32."""
    f32 = jnp.float32
    sdt = slot_dtype or f32

    def init(params):
        z = lambda p: jnp.zeros(p.shape, sdt)
        return (jax.tree.map(z, params), jax.tree.map(z, params),
                jax.tree.map(z, params))

    def update(grads, state, params=None):
        del params
        rg, rg2, ud = state

        def upd(g, a, a2, u):
            g = g.astype(f32)
            a_n = decay * a.astype(f32) + (1 - decay) * g
            a2_n = decay * a2.astype(f32) + (1 - decay) * (g * g)
            u_n = (momentum * u.astype(f32)
                   - (step_size * g) / jnp.sqrt(a2_n - a_n * a_n + eps))
            return u_n, a_n.astype(sdt), a2_n.astype(sdt), u_n.astype(sdt)

        out = jax.tree.map(upd, grads, rg, rg2, ud)
        pick = lambda i: jax.tree.map(
            lambda t: t[i], out, is_leaf=lambda t: isinstance(t, tuple))
        return pick(0), (pick(1), pick(2), pick(3))

    return optax.GradientTransformation(init, update)


def make_optimizer(tcfg: TrainConfig) -> optax.GradientTransformation:
    """Reference optimizers (common.py:§adadelta/§rmsprop/§sgd) as optax
    transforms, with the reference's global grad clipping (clip_c)."""
    if tcfg.optimizer == "adadelta":
        if tcfg.opt_slot_dtype == "bfloat16":
            opt = _adadelta_slot_dtype(tcfg.lr, jnp.bfloat16)
        else:
            opt = optax.adadelta(learning_rate=tcfg.lr)
    elif tcfg.optimizer == "rmsprop":
        # reference-exact Graves variant; deliberately ignores tcfg.lr
        # (the reference hardcodes 1e-4 — see graves_rmsprop docstring)
        opt = graves_rmsprop(
            slot_dtype=(jnp.bfloat16 if tcfg.opt_slot_dtype == "bfloat16"
                        else None))
    elif tcfg.optimizer == "sgd":
        # plain p -= lr*g, exactly the reference's common.py:§sgd
        # (optax.sgd emits -lr*g verbatim; parity pinned in tests)
        opt = optax.sgd(learning_rate=tcfg.lr)
    elif tcfg.optimizer == "adam":
        opt = optax.adam(learning_rate=tcfg.lr)
    else:
        raise ValueError(tcfg.optimizer)
    if tcfg.clip_c > 0:
        return optax.chain(optax.clip_by_global_norm(tcfg.clip_c), opt)
    return opt


def init_train_state(rng: jax.Array, mcfg: ModelConfig, tcfg: TrainConfig
                     ) -> TrainState:
    p_rng, s_rng = jax.random.split(rng)
    params = init_params(p_rng, mcfg)
    opt = make_optimizer(tcfg)
    return {"params": params, "opt_state": opt.init(params),
            "step": jnp.zeros((), jnp.int32), "rng": s_rng}


def make_train_step(
    mcfg: ModelConfig,
    tcfg: TrainConfig,
    step_fn: Optional[StepFn] = None,
    mesh=None,
    use_shard_map: bool = False,
) -> Callable[[TrainState, Dict[str, jax.Array]],
              Tuple[TrainState, Dict[str, jax.Array]]]:
    """Build the fused, jitted train step.

    With a mesh: state replicated / batch sharded on the data axis —
    jit emits the gradient allreduce.  ``use_shard_map`` picks
    the explicit-collective path (hand-placed ``lax.psum`` over the
    data axis) instead of relying on XLA's sharding propagation; both
    produce bit-identical updates (tests/test_parallel.py).
    """
    opt = make_optimizer(tcfg)
    if tcfg.grad_accum > 1 and mesh is not None:
        raise ValueError("grad_accum is the single-device memory lever; "
                         "with a mesh, shard the batch instead")
    tp = mesh is not None and parallel.MODEL_AXIS in mesh.axis_names
    if mesh is not None and use_shard_map:
        if tp:
            raise ValueError("use_shard_map is the explicit DP path; "
                             "tensor parallelism (a 2-D mesh) uses the "
                             "pjit path")
        return _make_shard_map_train_step(mcfg, tcfg, step_fn, mesh, opt)

    def _accum_loss_and_grads(params, batch, sub):
        """grad_accum > 1: lax.scan over microbatches, accumulating
        gradients of the SUMMED objective plus the loss_terms
        numerators/denominators; ONE weighted-mean divide at the end
        makes the result exactly the full-batch gradient regardless of
        how the wrap-padding weights split across microbatches (same
        decomposition the shard_map DP path psums).  Only one
        microbatch's activations are live at a time — the memory
        alternative to model.remat."""
        from .loss import loss_from_terms, loss_terms
        n = tcfg.grad_accum
        mb = jax.tree.map(
            lambda v: v.reshape((n, v.shape[0] // n) + v.shape[1:]), batch)

        def local_obj(params, mbatch, r):
            t = loss_terms(params, mcfg, mbatch, rng=r, train=True,
                           ss_prob=tcfg.ss_prob, step_fn=step_fn)
            return t["nll_num"] + mcfg.alpha_c * t["reg_num"], t

        def micro(carry, xs):
            acc_g, acc_t = carry
            mbatch, i = xs
            (_, t), g = jax.value_and_grad(local_obj, has_aux=True)(
                params, mbatch, jax.random.fold_in(sub, i))
            return (jax.tree.map(jnp.add, acc_g, g),
                    jax.tree.map(jnp.add, acc_t, t)), None

        zero_t = {"nll_num": jnp.zeros(()), "ex_den": jnp.zeros(()),
                  "tok_den": jnp.zeros(()), "reg_num": jnp.zeros(())}
        (grads, terms), _ = jax.lax.scan(
            micro, (jax.tree.map(jnp.zeros_like, params), zero_t),
            (mb, jnp.arange(n)))
        den = jnp.maximum(terms["ex_den"], 1.0)
        grads = jax.tree.map(lambda g: g / den, grads)
        loss, aux = loss_from_terms(terms, mcfg)
        return loss, aux, grads

    def train_step(state: TrainState, batch):
        rng, sub = jax.random.split(state["rng"])
        if tcfg.grad_accum > 1:
            loss, aux, grads = _accum_loss_and_grads(state["params"],
                                                     batch, sub)
        else:
            (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                state["params"], mcfg, batch, rng=sub, train=True,
                ss_prob=tcfg.ss_prob, step_fn=step_fn)
        updates, opt_state = opt.update(grads, state["opt_state"],
                                        state["params"])
        params = optax.apply_updates(state["params"], updates)
        gnorm = optax.global_norm(grads)
        new_state = {"params": params, "opt_state": opt_state,
                     "step": state["step"] + 1, "rng": rng}
        metrics = {"loss": loss, "nll": aux["nll"],
                   "nll_per_token": aux["nll_per_token"], "grad_norm": gnorm}
        return new_state, metrics

    donate = (0,) if tcfg.donate_state else ()
    if mesh is None:
        return jax.jit(train_step, donate_argnums=donate)
    rep = parallel.replicated(mesh)
    shard = parallel.batch_sharding(mesh)
    if tp:
        # 2-D (data x model) mesh: params/opt-slots carry TP_RULES
        # shardings (gates weights row-sharded -> one psum per matmul;
        # vocab logits column-sharded), batch sharded on 'data'; XLA
        # inserts the model-axis collectives from the layout.
        st_shape = jax.eval_shape(
            lambda: init_train_state(jax.random.PRNGKey(0), mcfg, tcfg))
        st_sh = parallel.state_shardings(st_shape, mesh)
        return jax.jit(
            train_step,
            in_shardings=(st_sh, shard),
            out_shardings=(st_sh, rep),
            donate_argnums=donate,
        )
    return jax.jit(
        train_step,
        in_shardings=(rep, shard),
        out_shardings=(rep, rep),
        donate_argnums=donate,
    )


def _make_shard_map_train_step(mcfg: ModelConfig, tcfg: TrainConfig,
                               step_fn, mesh, opt):
    """Explicit-collective data-parallel step (SURVEY.md §2 row 10).

    Each shard computes unreduced loss terms and local gradients of the
    summed objective; ``lax.psum`` over the 'data' axis (NVLink between
    the GPUs of one host) produces the exact global gradient before the
    (replicated) optimizer update — the same math as the single-device
    step.
    """
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from .loss import loss_from_terms, loss_terms

    def body(state, batch):
        rng, sub = jax.random.split(state["rng"])
        sub = jax.random.fold_in(sub, jax.lax.axis_index(parallel.DATA_AXIS))

        def local_obj(params):
            t = loss_terms(params, mcfg, batch, rng=sub, train=True,
                           ss_prob=tcfg.ss_prob, step_fn=step_fn)
            return t["nll_num"] + mcfg.alpha_c * t["reg_num"], t

        (_, terms), grads = jax.value_and_grad(local_obj, has_aux=True)(
            state["params"])
        psum = lambda x: jax.lax.psum(x, parallel.DATA_AXIS)
        grads = jax.tree.map(psum, grads)
        terms = {k: psum(v) for k, v in terms.items()}
        den = jnp.maximum(terms["ex_den"], 1.0)
        grads = jax.tree.map(lambda g: g / den, grads)
        loss, aux = loss_from_terms(terms, mcfg)
        updates, opt_state = opt.update(grads, state["opt_state"],
                                        state["params"])
        params = optax.apply_updates(state["params"], updates)
        new_state = {"params": params, "opt_state": opt_state,
                     "step": state["step"] + 1, "rng": rng}
        metrics = {"loss": loss, "nll": aux["nll"],
                   "nll_per_token": aux["nll_per_token"],
                   "grad_norm": optax.global_norm(grads)}
        return new_state, metrics

    sm = shard_map(body, mesh=mesh, in_specs=(P(), P(parallel.DATA_AXIS)),
                   out_specs=(P(), P()), check_vma=False)
    donate = (0,) if tcfg.donate_state else ()
    return jax.jit(sm, donate_argnums=donate)


_EVAL_NLL_CACHE: Dict[Any, Any] = {}


def make_eval_nll(mcfg: ModelConfig, step_fn: Optional[StepFn] = None):
    """Jitted validation NLL terms (reference §pred_probs), cached per
    config so repeated validation rounds reuse one executable.  The key
    holds step_fn itself (identity semantics, keeps it alive) — not
    ``id()``, which can be reused after GC."""
    key = (mcfg, step_fn)
    fn = _EVAL_NLL_CACHE.get(key)
    if fn is None:
        from .loss import loss_terms

        def eval_step(params, batch):
            t = loss_terms(params, mcfg, batch, train=False,
                           step_fn=step_fn)
            return t["nll_num"], t["ex_den"], t["tok_den"]

        fn = jax.jit(eval_step)
        _EVAL_NLL_CACHE[key] = fn
    return fn


def evaluate_nll_stats(params, mcfg: ModelConfig, ds: Dataset,
                       batch_size: int, step_fn: Optional[StepFn] = None
                       ) -> Tuple[float, float, float]:
    """(nll numerator, example count, token count) over a split.
    Fixed-shape batches: the wrapped tail carries zero weights instead
    of a ragged shape (one compiled executable)."""
    ev = make_eval_nll(mcfg, step_fn)
    dev = ds.bank.to_device(dtype=jnp.dtype(mcfg.compute_dtype))
    it = BatchIterator(ds.captions.n, min(batch_size, ds.captions.n),
                       shuffle=False)
    num = ex = tok = 0.0
    for idx, w in it.epoch():
        batch = gather_batch(dev, ds.captions, idx)
        batch["weight"] = jnp.asarray(w)
        n, d, t = ev(params, batch)
        num, ex, tok = num + float(n), ex + float(d), tok + float(t)
    return num, ex, tok


def evaluate_nll(params, mcfg: ModelConfig, ds: Dataset, batch_size: int,
                 step_fn: Optional[StepFn] = None) -> float:
    """Mean per-example NLL over a split (the early-stop signal the
    reference computes with pred_probs)."""
    num, ex, _ = evaluate_nll_stats(params, mcfg, ds, batch_size, step_fn)
    return num / max(ex, 1.0)


# ---------------------------------------------------------------------------
# Checkpointing — SURVEY.md §5 'Checkpoint / resume'
# ---------------------------------------------------------------------------

_CKPT_FILE = "state.npz"


def save_checkpoint(path: str, state: TrainState) -> None:
    """Write the full train state to ``path/state.npz``: one entry per
    leaf, keyed by its tree path, in the leaf's own dtype (bfloat16 and
    other dtypes numpy cannot name are stored as raw bits beside a dtype
    table).  The file is written under a temporary name and renamed, so
    a crash never leaves a half-written checkpoint."""
    import json
    os.makedirs(path, exist_ok=True)
    leaves, _ = jax.tree_util.tree_flatten_with_path(jax.device_get(state))
    arrays, dtypes = {}, {}
    for kp, leaf in leaves:
        a = np.asarray(leaf)
        key = jax.tree_util.keystr(kp)
        dtypes[key] = a.dtype.name
        if a.dtype.kind not in "biuf":       # e.g. bfloat16: save the bits
            a = a.view(f"u{a.dtype.itemsize}")
        arrays[key] = a
    arrays["__dtypes__"] = np.asarray(json.dumps(dtypes))
    tmp = os.path.join(path, _CKPT_FILE + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, os.path.join(path, _CKPT_FILE))


def restore_checkpoint(path: str, template: TrainState) -> TrainState:
    """Read a checkpoint written by ``save_checkpoint`` into the structure
    of ``template``.  Every template leaf must be present with the same
    shape; the stored dtype is kept."""
    import json
    leaves, treedef = jax.tree_util.tree_flatten_with_path(template)
    with np.load(os.path.join(path, _CKPT_FILE)) as z:
        dtypes = json.loads(str(z["__dtypes__"]))
        out = []
        for kp, leaf in leaves:
            key = jax.tree_util.keystr(kp)
            if key not in dtypes:
                raise KeyError(f"{path}: checkpoint has no entry {key}")
            a = z[key]
            if a.dtype.name != dtypes[key]:
                a = a.view(jnp.dtype(dtypes[key]))
            if a.shape != np.shape(leaf):
                raise ValueError(f"{path}: {key} has shape {a.shape}, "
                                 f"expected {np.shape(leaf)}")
            # on device, so traced indexing (Wemb[token] inside decode
            # scans) works
            out.append(jnp.asarray(a))
    return jax.tree_util.tree_unflatten(treedef, out)


def _fit_state_path(save_dir: str) -> str:
    return os.path.join(save_dir, "fit_state.json")


def save_fit_state(save_dir: str, *, best: float, best_step: int,
                   bad_rounds: int, history: list, metric: str) -> None:
    """Persist the early-stop bookkeeping next to the checkpoint
    (the reference saves ``history_errs`` with the model — SURVEY.md §5;
    without this, a resumed run re-saves a worse "best" checkpoint and
    restarts patience from zero)."""
    import json
    import math
    d = {"best": float(best) if math.isfinite(best) else None,
         "best_step": int(best_step), "bad_rounds": int(bad_rounds),
         "history": history, "metric": metric}
    path = _fit_state_path(save_dir)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(d, f)
    os.replace(tmp, path)


def load_fit_state(save_dir: str, metric: str) -> Optional[dict]:
    """Early-stop state from a previous fit(), or None if absent or the
    early-stop metric changed (stale best values are not comparable)."""
    import json
    path = _fit_state_path(save_dir)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        d = json.load(f)
    if d.get("metric") != metric:
        return None
    return d


# ---------------------------------------------------------------------------
# The full fit loop (reference train() epoch loop)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FitResult:
    best_metric: float
    best_step: int
    history: list
    state: TrainState
    bad_rounds: int = 0


def fit(
    cfg: Config,
    train_ds: Dataset,
    valid_ds: Optional[Dataset] = None,
    step_fn: Optional[StepFn] = None,
    mesh=None,
    logger: Optional[MetricsLogger] = None,
    max_updates: Optional[int] = None,
    use_shard_map: Optional[bool] = None,
    test_ds: Optional[Dataset] = None,
) -> FitResult:
    """Train until max_epochs / patience exhausted (reference §train).

    Early stopping: track the chosen validation metric (meteor/bleu4/
    cider from generated captions, or nll); save best + periodic
    checkpoints in cfg.train.save_dir.  ``test_ds``, when given, is
    scored at every validation round exactly like the reference's
    train() (SURVEY.md §3.1 computes NLL + metrics for valid AND test
    every validFreq) — model selection still uses valid only.
    """
    tcfg, mcfg = cfg.train, cfg.model
    if use_shard_map is None:
        use_shard_map = tcfg.use_shard_map
    # batch shards over the DATA axis only (a 2-D TP mesh's 'model'
    # axis never splits the batch)
    dp_size = mesh.shape[parallel.DATA_AXIS] if mesh is not None else 1
    if mesh is not None and tcfg.per_device_batch > 0:
        # DP recipes specify a per-device batch so the same config is
        # valid on any slice size (config 5, SURVEY.md §2 row 9)
        tcfg = dataclasses.replace(
            tcfg, batch_size=tcfg.per_device_batch * dp_size)
    if mesh is not None and tcfg.batch_size % dp_size != 0:
        raise ValueError(
            f"batch_size {tcfg.batch_size} must be divisible by the mesh "
            f"data-axis size {dp_size} (static data-parallel sharding)")
    if tcfg.debug_nans:
        from ..utils.debug import enable_nan_debug
        enable_nan_debug(True)
    own_logger = logger is None
    log = logger or MetricsLogger(tcfg.save_dir,
                              tensorboard=tcfg.tensorboard)
    rng = jax.random.PRNGKey(tcfg.seed)
    state = init_train_state(rng, mcfg, tcfg)
    if mesh is not None:
        if parallel.MODEL_AXIS in mesh.axis_names:
            state = parallel.shard_state(state, mesh)
        else:
            state = parallel.replicate(state, mesh)

    metric_name = tcfg.metric
    bigger_is_better = metric_name != "nll"
    best = -np.inf if bigger_is_better else np.inf
    best_step = 0
    bad_rounds = 0
    history = []

    ckpt_dir = os.path.join(tcfg.save_dir, "ckpt")
    best_dir = os.path.join(tcfg.save_dir, "ckpt_best")
    if tcfg.reload_ and os.path.exists(ckpt_dir):
        state = restore_checkpoint(ckpt_dir, state)
        fs = load_fit_state(tcfg.save_dir, metric_name)
        if fs is not None:
            if fs["best"] is not None:
                best = fs["best"]
            best_step = fs["best_step"]
            bad_rounds = fs["bad_rounds"]
            history = fs["history"]
        log.log("reload", step=int(state["step"]), best=float(best),
                bad_rounds=bad_rounds)

    train_step = make_train_step(mcfg, tcfg, step_fn, mesh,
                                 use_shard_map=use_shard_map)
    dev = train_ds.bank.to_device(dtype=jnp.dtype(mcfg.compute_dtype))
    if tcfg.length_buckets:
        from ..config import parse_buckets
        from ..data.batching import BucketedBatchIterator
        buckets = parse_buckets(tcfg.length_buckets)
        if max(buckets) < tcfg.maxlen:
            buckets = buckets + (tcfg.maxlen,)
        lens = train_ds.captions.mask.sum(axis=1).astype(np.int64)
        it = BucketedBatchIterator(lens, tcfg.batch_size, buckets,
                                   seed=tcfg.seed)
    else:
        it = BatchIterator(train_ds.captions.n, tcfg.batch_size,
                           seed=tcfg.seed)
    sampler = _make_sampler(mcfg, cfg.decode.maxlen, step_fn)
    from ..utils.profiling import StepTimer
    timer = StepTimer(window=max(tcfg.disp_freq, 10))

    update = int(state["step"])
    stop = False
    tracing = False

    def _persist_fit_state():
        save_fit_state(tcfg.save_dir, best=best, best_step=best_step,
                       bad_rounds=bad_rounds, history=history,
                       metric=metric_name)

    try:
        for epoch in range(tcfg.max_epochs):
            if stop:
                break
            for item in it.epoch():
                # BucketedBatchIterator adds the bucket length (a static
                # shape: one compiled executable per bucket)
                idx, w = item[0], item[1]
                t_b = item[2] if len(item) == 3 else 0
                batch = gather_batch(dev, train_ds.captions, idx,
                                     seq_len=t_b)
                batch["weight"] = jnp.asarray(w)
                if mesh is not None:
                    batch = parallel.shard_batch(batch, mesh)
                if tcfg.profile_dir and update == tcfg.profile_start:
                    # profile window: trace the next profile_steps
                    # train updates (post-compile by default)
                    jax.profiler.start_trace(tcfg.profile_dir)
                    tracing = True
                state, m = train_step(state, batch)
                update += 1
                if tracing and update >= (tcfg.profile_start
                                          + tcfg.profile_steps):
                    jax.block_until_ready(m["loss"])
                    jax.profiler.stop_trace()
                    tracing = False
                    log.log("profile", dir=tcfg.profile_dir,
                            first_update=tcfg.profile_start + 1,
                            steps=tcfg.profile_steps)
                rate = timer.tick()
                if update % tcfg.disp_freq == 0:
                    extra = {"steps_per_sec": round(rate, 2)} if rate else {}
                    log.log("train", epoch=epoch, update=update,
                            loss=m["loss"], grad_norm=m["grad_norm"],
                            **extra)
                if tcfg.sample_freq > 0 and update % tcfg.sample_freq == 0:
                    _print_samples(state["params"], cfg, train_ds, dev,
                                   sampler, log, update)
                if tcfg.valid_freq > 0 and update % tcfg.valid_freq == 0 \
                        and valid_ds is not None:
                    scores = _validate(state["params"], cfg, valid_ds,
                                       step_fn, log, update)
                    if test_ds is not None:
                        _validate(state["params"], cfg, test_ds, step_fn,
                                  log, update, split="test")
                    val = scores[_metric_key(metric_name)]
                    history.append({"update": update, **scores})
                    improved = ((val > best) if bigger_is_better
                                else (val < best))
                    if improved:
                        best, best_step, bad_rounds = val, update, 0
                        save_checkpoint(best_dir, state)
                        log.log("best", update=update, metric=metric_name,
                                value=val)
                    else:
                        bad_rounds += 1
                        if bad_rounds >= tcfg.patience:
                            log.log("early_stop", update=update,
                                    bad_rounds=bad_rounds)
                            stop = True
                    _persist_fit_state()
                    if stop:
                        break
                if tcfg.save_freq > 0 and update % tcfg.save_freq == 0:
                    save_checkpoint(ckpt_dir, state)
                    _persist_fit_state()
                if max_updates is not None and update >= max_updates:
                    stop = True
                    break
    except KeyboardInterrupt:
        # graceful interrupt: persist current state before exiting (the
        # reference loses all progress since the last saveFreq save)
        log.log("interrupt", update=update)
    if tracing:   # run ended inside the profile window
        jax.profiler.stop_trace()
    save_checkpoint(ckpt_dir, state)
    _persist_fit_state()
    if own_logger:
        log.close()
    return FitResult(best_metric=float(best), best_step=best_step,
                     history=history, state=state, bad_rounds=bad_rounds)


def _make_sampler(mcfg: ModelConfig, maxlen: int, step_fn):
    """Jitted greedy sampler compiled once per fit() (the reference
    prints train/valid samples every sampleFreq — SURVEY.md §3.1)."""
    from ..decode.greedy import greedy_decode

    def run(params, batch):
        return greedy_decode(params, mcfg, batch, maxlen=maxlen,
                             step_fn=step_fn).tokens

    return jax.jit(run)


def _print_samples(params, cfg: Config, ds: Dataset, dev, sampler, log,
                   update: int, n: int = 2) -> None:
    rows = np.arange(min(n, ds.bank.n_videos))
    batch = {"frames": jnp.take(dev["frames"], rows, axis=0),
             "frame_mask": jnp.take(dev["frame_mask"], rows, axis=0)}
    for key in ("regions", "motion"):
        if key in dev:
            batch[key] = jnp.take(dev[key], rows, axis=0)
    toks = np.asarray(sampler(params, batch))
    for i, r in enumerate(rows):
        pred = " ".join(ds.vocab.decode(toks[i]))
        gold = " ".join(ds.references[r][0]) if ds.references[r] else ""
        log.log("sample", update=update, video=ds.bank.ids[r], pred=pred,
                gold=gold)


def _metric_key(name: str) -> str:
    # 'blue' is the reference's (misspelled) early-stop metric option
    return {"meteor": "METEOR", "bleu4": "Bleu_4", "blue": "Bleu_4",
            "cider": "CIDEr", "rouge": "ROUGE_L", "nll": "nll"}[name]


def _validate(params, cfg: Config, valid_ds: Dataset, step_fn, log,
              update: int, split: str = "valid") -> Dict[str, float]:
    nll = evaluate_nll(params, cfg.model, valid_ds,
                       cfg.train.valid_batch_size, step_fn)
    scores = evaluate_split(params, cfg, valid_ds, split=split,
                            save_dir=cfg.train.save_dir, step_fn=step_fn)
    scores["nll"] = nll
    log.log(split, update=update, **scores)
    return scores


def perplexity(nll_per_token: float) -> float:
    """Token-level perplexity (the reference prints it next to NLL)."""
    import math
    return math.exp(min(nll_per_token, 50.0))
