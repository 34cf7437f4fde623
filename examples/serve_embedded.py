"""Embed the serving facade in your own process: hot state updates, online
ratings, cold-user fold-in — the library behind `python -m ycnr_tpu serve`.

Run: python examples/serve_embedded.py           (add --cpu without a GPU)
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if "--cpu" in sys.argv:
    import jax

    jax.config.update("jax_platforms", "cpu")

from ycnr_tpu.config import ALSConfig, DataConfig, RunConfig
from ycnr_tpu.data.dataset import Dataset
from ycnr_tpu.data.split import train_test_split
from ycnr_tpu.serve.engine import Recommender
from ycnr_tpu.train.loop import train

rng = np.random.default_rng(1)
n_users, n_items = 400, 200
u = rng.integers(0, n_users, 12_000).astype(np.int32)
i = rng.integers(0, n_items, 12_000).astype(np.int32)
r = rng.uniform(1.0, 5.0, 12_000).astype(np.float32)
(tu, ti, tr), (su, si, sr) = train_test_split(u, i, r, 0.1, seed=1)
ds = Dataset(n_users=n_users, n_items=n_items, train_u=tu, train_i=ti,
             train_r=tr, test_u=su, test_i=si, test_r=sr,
             mu=float(tr.mean()), chunk_len=16, rank_hint=8)
res = train(RunConfig(name="srv", algorithm="als", data=DataConfig(),
                      als=ALSConfig(rank=8, epochs=4), out_dir=""),
            dataset=ds, out_dir=None)

rec = Recommender(res.state, tu, ti, train_r=tr)

# plain top-N (rated items are masked out)
print("user 7 top-5:", rec.recommend(7, n=5))

# online update: user 7 rates two more items; their next recs fold the new
# observations in (re-solving just that user) and mask the new items
rec.add_ratings(7, [11, 23], [5.0, 4.5])
print("user 7 after add_ratings:", rec.recommend(7, n=5))

# cold user: never seen in training — fold-in from an ad-hoc rating list
print("cold user top-5:", rec.recommend_cold([3, 50, 120],
                                             [5.0, 4.0, 1.0], n=5))
