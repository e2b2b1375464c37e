"""Debugging aids (SURVEY.md §5 'race detection / sanitizers').

The reference's only numeric-health tool is ``common.py:§grad_nan_report``
(dump per-param gradient stats when the cost goes NaN).  JAX-native
equivalents: ``jax_debug_nans`` as the always-on mode, plus a pure
functional per-parameter gradient stats report usable inside jit via
``jax.debug.print`` or host callbacks.
"""

from __future__ import annotations

from typing import Any, Dict

import jax
import jax.numpy as jnp


def enable_nan_debug(enable: bool = True) -> None:
    """Moral equivalent of the reference's grad_nan_report hook: make
    XLA raise on the first NaN-producing op."""
    jax.config.update("jax_debug_nans", enable)


def grad_stats(grads: Any) -> Dict[str, Dict[str, jax.Array]]:
    """Per-parameter gradient statistics (norm / max / any-nan), jittable.

    Reference parity: ``common.py:§grad_nan_report`` prints the same
    per-param numbers when the cost goes NaN.
    """
    flat = jax.tree_util.tree_leaves_with_path(grads)
    out = {}
    for path, g in flat:
        name = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in path)
        g32 = g.astype(jnp.float32)
        out[name] = {
            "l2": jnp.sqrt(jnp.sum(g32 * g32)),
            "absmax": jnp.max(jnp.abs(g32)),
            "nan": jnp.any(jnp.isnan(g32)) | jnp.any(jnp.isinf(g32)),
        }
    return out


def report_bad_grads(grads: Any) -> None:
    """Host-side print of any non-finite gradient entries."""
    stats = jax.device_get(grad_stats(grads))
    bad = {k: v for k, v in stats.items() if bool(v["nan"])}
    if bad:
        for k, v in sorted(bad.items()):
            print(f"[grad-nan] {k}: l2={float(v['l2']):.4g} "
                  f"absmax={float(v['absmax']):.4g}")
