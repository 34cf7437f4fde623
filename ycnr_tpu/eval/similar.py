"""Item-item similarity over the trained item factors.

Extension of the serving layer (SURVEY.md C13 is user top-N; the factor
matrix the reference keeps in shm supports the item-side query for free):
"more like this" = top-n items by cosine (or dot) similarity of V rows.
Runs as one [B, k] x [k, n_items] matmul per request batch — the same
shape as the user scorer.

Cold items (zero factor rows — never rated, or the trailing trash row) are
masked out of both sides: they carry no signal, and a zero row's cosine is
0/eps noise.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ycnr_tpu.eval.recommend import NEG_INF
from ycnr_tpu.models.base import MFState


@partial(jax.jit, static_argnames=("n", "metric"))
def _similar_program(V, item_ids, n: int, metric: str):
    norms = jnp.sqrt(jnp.sum(V * V, axis=1))
    live = norms > 0.0
    if metric == "cosine":
        Vq = V / jnp.maximum(norms, 1e-12)[:, None]
    else:
        Vq = V
    Q = Vq[item_ids]  # [B, k]
    scores = Q @ Vq.T  # [B, n_items + 1]
    scores = jnp.where(live[None, :], scores, NEG_INF)
    # a cold QUERY row (zero factors) carries no signal: mask its whole row
    # so callers' `> NEG_INF/2` filter yields an empty list, matching
    # precompute_similar's skip — not an arbitrary zero-score ranking
    scores = jnp.where(live[item_ids][:, None], scores, NEG_INF)
    rows = jnp.arange(item_ids.shape[0])
    scores = scores.at[rows, item_ids].set(NEG_INF)  # self
    return lax.top_k(scores, n)


def similar_items(state: MFState, item_ids, n: int = 10,
                  metric: str = "cosine"):
    """(items [B, n], scores [B, n]) of the most similar catalog items for
    each query item; self and cold items masked to NEG_INF (a cold QUERY
    masks its whole row — filter `scores > NEG_INF / 2` to drop). metric:
    "cosine" (scale-free; default) or "dot" (popularity-weighted — factor
    row norms grow with rating count)."""
    if metric not in ("cosine", "dot"):
        raise ValueError(f"metric must be 'cosine' or 'dot', got {metric!r}")
    item_ids = jnp.asarray(np.asarray(item_ids).reshape(-1), jnp.int32)
    n = min(int(n), state.n_items - 1)  # self is always excluded
    scores, items = _similar_program(state.V, item_ids, n, metric)
    return np.asarray(items), np.asarray(scores)
