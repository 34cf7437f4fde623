"""Round-2 features end to end: stream-SGD training + the concurrent TCP
serving service with dynamic micro-batching.

* trains SGD-MF with the scatter-free stream epoch (models/sgd_stream.py),
  then
* serves the factors behind the thread-per-connection TCP server
  (serve/server.py) and fires a burst of concurrent clients at it,
  printing the latency histogram from the `stats` request.

Run: python examples/stream_sgd_and_serving.py     (add --cpu without a GPU)
"""

import json
import os
import socket
import sys
import threading

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if "--cpu" in sys.argv:
    import jax

    jax.config.update("jax_platforms", "cpu")

from ycnr_tpu.config import DataConfig, RunConfig, SGDConfig
from ycnr_tpu.serve.engine import Recommender
from ycnr_tpu.serve.server import ServingApp, serve_tcp
from ycnr_tpu.train.loop import train

# -- train with the stream epoch ------------------------------------------
cfg = RunConfig(
    name="stream-demo", algorithm="sgd",
    data=DataConfig(source="synthetic", n_users=1200, n_items=400,
                    n_ratings=60_000, true_rank=6, seed=11),
    sgd=SGDConfig(rank=8, lr=0.03, epochs=6, batch_size=2048,
                  method="stream"),  # <- the scatter-free stream layout
    out_dir="", checkpoint_every=0, log_train_rmse=False)
res = train(cfg, out_dir=None)
print(f"stream-SGD RMSE: {res.rmse_history[0]:.4f} -> "
      f"{res.rmse_history[-1]:.4f}")

# -- serve it concurrently over TCP ---------------------------------------
ds = res.dataset
rec = Recommender(res.state, ds.train_u, ds.train_i, train_r=ds.train_r)
app = ServingApp(rec, n=10, store_meta={"n_users": ds.n_users,
                                        "n_items": ds.n_items})
srv = serve_tcp(app, "127.0.0.1", 0)
addr = srv.server_address[:2]
threading.Thread(target=srv.serve_forever, daemon=True).start()
print(f"serving on {addr[0]}:{addr[1]}")


def client(user_ids, out):
    with socket.create_connection(addr) as s:
        f = s.makefile("rw")
        for u in user_ids:
            f.write(f"{u}\n")
            f.flush()
            out.append(json.loads(f.readline()))


rng = np.random.default_rng(0)
outs = [[] for _ in range(8)]
threads = [threading.Thread(
    target=client, args=(rng.integers(0, ds.n_users, 50).tolist(), outs[c]))
    for c in range(8)]
for t in threads:
    t.start()
for t in threads:
    t.join()
assert all(len(o) == 50 and all("items" in r for r in o) for o in outs)
stats = json.loads(app.handle("stats"))
print(f"served {stats['latency']['count']} requests; "
      f"p50={stats['latency']['p50_ms']} ms "
      f"p99={stats['latency']['p99_ms']} ms "
      f"batches={stats['batches']} "
      f"(avg batch {stats['batched_requests'] / max(stats['batches'], 1):.1f})")
srv.shutdown()
srv.server_close()
print("OK")
