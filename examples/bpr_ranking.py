"""Implicit-feedback ranking end to end: BPR-MF training + ranked serving.

* trains BPR (models/bpr.py — pairwise ranking with on-device negative
  sampling; the reference engine has only pointwise trainers),
* compares ranking quality (hit-rate@10 / NDCG@10) against the pointwise
  implicit model (iALS) on the same data, and
* serves "because you liked X" recommendations plus point predictions
  from the trained factors.

(A popularity top-10 is also printed for context: on this synthetic the
WHICH-items-get-interacted pattern is Zipf-sampled by construction, so
raw popularity is a strong random-holdout baseline — the model-to-model
comparison is the meaningful one.)

Run: python examples/bpr_ranking.py     (add --cpu without a GPU)
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if "--cpu" in sys.argv:
    import jax

    jax.config.update("jax_platforms", "cpu")

from ycnr_tpu.config import BPRConfig, DataConfig, IALSConfig, RunConfig
from ycnr_tpu.eval.ranking import ranking_metrics_at_n
from ycnr_tpu.eval.recommend import top_popular
from ycnr_tpu.serve.engine import Recommender
from ycnr_tpu.train.loop import train

cfg = RunConfig(
    name="bpr-example", algorithm="bpr", out_dir="",
    data=DataConfig(source="synthetic", n_users=400, n_items=200,
                    n_ratings=12_000, true_rank=6, chunk_len=16),
    bpr=BPRConfig(rank=16, lam=0.01, lr=0.1, epochs=15, batch_size=2048),
    topn=10)

res = train(cfg)
hr_traj = [round(1.0 - x, 3) for x in res.rmse_history]  # hit-rate per epoch
print("hit-rate@10 trajectory:", hr_traj)
assert hr_traj[-1] > hr_traj[0], "ranking quality should improve"

ds = res.dataset
m = ranking_metrics_at_n(res.state, ds.train_u, ds.train_i,
                         ds.test_u, ds.test_i, n=10, max_users=512)
print(f"BPR     hit@10={m['hit_rate']:.3f} ndcg@10={m['ndcg']:.3f}")

# pointwise implicit model on the same data (same rank, same split)
ials_res = train(RunConfig(
    name="ials-baseline", algorithm="ials", out_dir="",
    data=cfg.data, ials=IALSConfig(rank=16, lam=0.1, alpha=10.0, epochs=8),
    topn=10), dataset=ds)
mi = ranking_metrics_at_n(ials_res.state, ds.train_u, ds.train_i,
                          ds.test_u, ds.test_i, n=10, max_users=512)
print(f"iALS    hit@10={mi['hit_rate']:.3f} ndcg@10={mi['ndcg']:.3f}  "
      f"(pairwise lift {m['hit_rate'] / max(mi['hit_rate'], 1e-9):.2f}x)")
assert m["hit_rate"] > mi["hit_rate"], \
    "pairwise ranking should beat the pointwise model at ranking"

# popularity context (see module docstring)
pop = top_popular(ds.train_i, ds.n_items, 10)
by_user = {}
for u, i in zip(ds.test_u.tolist(), ds.test_i.tolist()):
    by_user.setdefault(u, set()).add(i)
pop_hit = np.mean([bool(by_user[u] & set(pop.tolist()))
                   for u in by_user])
print(f"popular hit@10={pop_hit:.3f}  (Zipf-sampled interactions: "
      f"popularity is a strong baseline on this synthetic)")

# serving from the ranked model: top-N, similar items, point predictions
rec = Recommender(res.state, ds.train_u, ds.train_i, train_r=ds.train_r)
uid = int(ds.test_u[0])
top = rec.recommend(uid, 5)
print(f"user {uid}: top-5 {top.tolist()}")
assert not set(top.tolist()) & set(
    ds.train_i[ds.train_u == uid].tolist()), "rated items must be masked"
scores = rec.predict(uid, top[:3])
print(f"user {uid}: predict({top[:3].tolist()}) -> "
      f"{[round(float(s), 3) for s in scores]}")
liked = int(ds.train_i[ds.train_u == uid][0])
print(f"because you liked {liked}: {rec.similar(liked, 5).tolist()}")
print("OK")
