"""Model-parallel (tensor-parallel) decode over a 2-D data x model mesh.

The reference decodes on a single GPU (``model_attention.py:§gen_sample``
— SURVEY.md §3.3); TP decode has no reference equivalent.  It exists for
the same reason as ``train.parallel.TP_RULES``: when the decoder dims
outgrow one device, the scale-out axis must cover inference too, not
just training.

Design — identical to the training TP story (the scaling-book recipe:
annotate shardings, let XLA insert collectives):

  * params are placed per ``TP_RULES`` — gates/input GEMM weights
    row-sharded over 'model' (XLA emits one psum per matmul), the vocab
    logit matmul column-sharded, everything small replicated;
  * the batch (and therefore the whole beam state, B*k rows) is sharded
    over 'data' and REPLICATED over 'model' — the serial while_loop body
    is untouched, only the per-step GEMMs partition;
  * the vocab-sharded logits are all-gathered (over 'model') for the
    top-k merge — at (B*k, V<=20k) f32 this is tiny next to the gates
    GEMM traffic the sharding saves.

The step runs the plain XLA path, logit tail included: a
``pallas_call`` does not partition under sharding propagation, and
XLA's GEMM partitioning is where TP's win lives.

Parity invariant (tested on the virtual 8-device mesh): tp decode ==
single-device ``beam_decode`` on tokens and scores, for temporal and
spatial configs.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from ..config import ModelConfig
from ..train import parallel as tparallel
from .beam import BeamOut, beam_decode


def shard_decode_params(params: Dict[str, Any], mesh) -> Dict[str, Any]:
    """Place a params dict per TP_RULES (shardable GEMM weights split
    over 'model', the rest replicated).  Same rules as training —
    ``train.parallel.state_shardings`` keys off dict names, so it
    accepts the bare params dict directly."""
    return tparallel.shard_state(params, mesh)


def make_tp_beam_decode(cfg: ModelConfig, mesh, beam_size: int = 5,
                        maxlen: int = 30, length_norm: float = 0.6,
                        norm_mode: str = "gnmt"
                        ) -> Callable[[Dict, Dict], BeamOut]:
    """Build a jitted TP beam decode: ``fn(params, batch) -> BeamOut``.

    ``params`` should be pre-placed with :func:`shard_decode_params` and
    ``batch`` with ``train.parallel.shard_batch`` (placement drives the
    partitioning — the jit itself carries no in_shardings, so the same
    callable also runs unsharded inputs on one device).  Batch size must
    divide the 'data' axis; param dims that don't divide the 'model'
    axis fall back to replicated per ``TP_RULES``' divisibility rule.

    Outputs are constrained to batch-sharded layout (leading axis over
    'data', replicated over 'model') so callers can np.asarray them
    without a surprise cross-device gather layout.
    """
    out_sharding = NamedSharding(mesh, P(tparallel.DATA_AXIS))

    def run(params, batch):
        out = beam_decode(params, cfg, batch, beam_size=beam_size,
                          maxlen=maxlen, length_norm=length_norm,
                          norm_mode=norm_mode)
        return jax.tree.map(
            lambda x: jax.lax.with_sharding_constraint(x, out_sharding),
            out)

    return jax.jit(run)
