"""Data parallelism over a device mesh.

The reference is single-process/single-GPU with NO distributed backend
(SURVEY.md §2 rows 9-10).  The equivalent specified there: a 1-D
``jax.sharding.Mesh(('data',))`` over a plain device list, batch
sharded on the data axis, parameters replicated, gradient allreduce
emitted by XLA as ``psum`` collectives.  Two code paths are provided:

  * the pjit path (primary): ``jax.jit`` with NamedShardings — XLA
    inserts the allreduce automatically from the sharding layout,
  * an explicit ``shard_map`` path with a hand-placed ``lax.psum``,
    used by tests to pin the collective semantics (grad parity with
    single-device — SURVEY.md §4 'distributed without a cluster').

The GPUs of one host reach each other all to all over NVLink, so the
mesh follows the algorithm alone (no topology shaping); multi-host is
out of scope.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"


def make_mesh(devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """1-D data-parallel mesh over all (or the given) devices."""
    devs = list(devices) if devices is not None else jax.devices()
    return Mesh(np.asarray(devs), (DATA_AXIS,))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Leading-axis (batch) sharding."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(batch: Dict[str, jax.Array], mesh: Mesh) -> Dict[str, jax.Array]:
    """Place a host batch with its leading axis split over the data axis.

    Batch size must divide the mesh size (static shapes; the batch
    iterator already pads ragged tails).
    """
    s = batch_sharding(mesh)
    return {k: jax.device_put(v, s) for k, v in batch.items()}


def replicate(tree: Any, mesh: Mesh) -> Any:
    """Replicate a pytree (params / optimizer state) across the mesh."""
    s = replicated(mesh)
    return jax.tree.map(lambda x: jax.device_put(x, s), tree)


def psum_mean_grads(grads: Any, axis_name: str = DATA_AXIS) -> Any:
    """Explicit gradient allreduce (used inside shard_map bodies)."""
    return jax.tree.map(lambda g: jax.lax.pmean(g, axis_name), grads)


# ---------------------------------------------------------------------------
# Tensor parallelism (2-D data x model mesh)
#
# No reference equivalent (the reference is single-GPU Theano); this is
# the device-level scale-out axis beyond DP for when the model dims grow.
# Design (the scaling-book recipe — annotate, let XLA insert
# collectives):
#
#   * the recurrent/gates/input GEMM weights are ROW-sharded (input
#     axis over 'model'): each shard contracts its slice of the input
#     features and XLA emits ONE psum per matmul over the model axis;
#     activations stay replicated, so the serial scan's step math is
#     untouched.  (Column-sharding the 4d gates axis would slice the
#     i/f/o/c gate boundaries across shards and force reshards inside
#     the elementwise gate math.)
#   * the vocab logit matmul is COLUMN-sharded ('model' over n_words):
#     each shard owns a vocab slice; the softmax-CE logsumexp combine
#     is the natural cross-shard reduction.
#   * everything small (biases, attention vectors, embeddings) is
#     replicated.
#
# Why no pp/sp/ep: the model is a single-layer recurrent decoder —
# there is no layer stack to pipeline, the scan is serial in time (no
# sequence parallelism inside a step), and there are no experts.
# dp x tp is the complete mesh story for this architecture.
# ---------------------------------------------------------------------------

MODEL_AXIS = "model"

# param-name -> PartitionSpec for every weight worth sharding; any
# param not listed is replicated.  Covers all four configs (temporal,
# spatial, motion dual-stream, lstm encoder).
TP_RULES: Dict[str, P] = {
    # gates GEMMs: row/input-sharded
    "U": P(MODEL_AXIS, None),            # (d, 4d) recurrent
    "W": P(MODEL_AXIS, None),            # (dw, 4d) input proj
    "Wc": P(MODEL_AXIS, None),           # (ctx, 4d) context proj
    # logit tail: dw-input row-sharded projections, vocab-column output
    "ff_logit_lstm_W": P(MODEL_AXIS, None),   # (d, dw)
    "ff_logit_ctx_W": P(MODEL_AXIS, None),    # (ctx, dw)
    "ff_logit_W": P(None, MODEL_AXIS),        # (dw, V) vocab-sharded
    "ff_logit_b": P(MODEL_AXIS),              # (V,)
    # attention / selector / init projections (input-sharded)
    "Wc_att": P(MODEL_AXIS, None),       # (ctx, attn)
    "Wd_att": P(MODEL_AXIS, None),       # (d, attn)
    "ff_state_W": P(MODEL_AXIS, None),   # (ctx, d)
    "ff_memory_W": P(MODEL_AXIS, None),  # (ctx, d)
    # spatial mirror (config 2/4)
    "Ws_att": P(MODEL_AXIS, None),       # (Dr, s)
    "Wsd_att": P(MODEL_AXIS, None),      # (d, s)
    "W_spat_fuse": P(MODEL_AXIS, None),  # (Dr, ctx)
    # motion stream + lstm encoder
    "W_app": P(MODEL_AXIS, None),
    "W_mot": P(MODEL_AXIS, None),
    "enc_W": P(MODEL_AXIS, None),
    "enc_U": P(MODEL_AXIS, None),
}


def make_mesh_2d(devices: Optional[Sequence[jax.Device]] = None,
                 model_parallel: int = 1) -> Mesh:
    """2-D (data x model) mesh.  model_parallel=1 degenerates to DP."""
    devs = list(devices) if devices is not None else jax.devices()
    n = len(devs)
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by "
                         f"model_parallel={model_parallel}")
    arr = np.asarray(devs).reshape(n // model_parallel, model_parallel)
    return Mesh(arr, (DATA_AXIS, MODEL_AXIS))


def _tp_spec_for(name: str, leaf: Any, mesh: Mesh) -> P:
    """TP_RULES entry if the named axis divides evenly, else replicated
    (small presets may not divide every dim by the model-axis size)."""
    spec = TP_RULES.get(name)
    if spec is None:
        return P()
    m = mesh.shape[MODEL_AXIS]
    shape = getattr(leaf, "shape", ())
    for ax, s in enumerate(spec):
        if s == MODEL_AXIS and (ax >= len(shape) or shape[ax] % m):
            return P()
    return spec


def state_shardings(state: Any, mesh: Mesh) -> Any:
    """NamedSharding pytree for a TrainState under the 2-D mesh.

    Params (and their optimizer slots — optax states mirror the params
    dict, so the innermost dict key IS the param name) get TP_RULES
    specs; everything else is replicated."""
    def spec(path, leaf):
        name = None
        for k in path:
            if isinstance(k, jax.tree_util.DictKey) and k.key in TP_RULES:
                name = k.key
        p = _tp_spec_for(name, leaf, mesh) if name else P()
        return NamedSharding(mesh, p)

    return jax.tree_util.tree_map_with_path(spec, state)


def shard_state(state: Any, mesh: Mesh) -> Any:
    """Place a TrainState according to state_shardings."""
    sh = state_shardings(state, mesh)
    return jax.tree.map(jax.device_put, state, sh)
