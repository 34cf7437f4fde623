"""Every shipped preset must construct and train end-to-end (tiny synthetic).

Catches config drift: a preset whose fields stop matching the train loop /
data layer breaks here, not on a user's first real run. The BASELINE configs
themselves (real datasets / full scale) are exercised by bench.py and
chip_smoke.py on the GPU; here each preset's *wiring* runs one epoch on a
small synthetic override (the netflix-sharded preset runs its real 4-shard
mesh path on the fake CPU mesh from conftest).
"""

import dataclasses
import tempfile

import numpy as np
import pytest

from ycnr_tpu.config import get_preset, list_presets
from ycnr_tpu.train.loop import train


@pytest.mark.parametrize("name", list_presets() + ["netflix-sharded/dual"])
def test_preset_trains(name):
    if name.endswith("/dual"):  # item_sharded V-step mode over the mesh
        cfg = get_preset(name.split("/")[0])
        cfg = cfg.replace(mesh=dataclasses.replace(
            cfg.mesh, vstep_mode="item_sharded"))
    else:
        cfg = get_preset(name)
    cfg = cfg.replace(
        data=dataclasses.replace(cfg.data, source="synthetic", n_users=96,
                                 n_items=48, n_ratings=1800, chunk_len=8),
        out_dir=tempfile.mkdtemp(), measure_serving=True)
    for field in ("als", "sgd", "ials", "bpr"):
        cfg = cfg.replace(**{field: dataclasses.replace(
            getattr(cfg, field), epochs=2, rank=6)})
    res = train(cfg)
    assert len(res.rmse_history) == 2
    assert np.isfinite(res.rmse_history[-1])
    # training reduces held-out RMSE from the cold init on every algorithm
    assert res.rmse_history[-1] < 3.0
    # measure_serving=True must log a recs/s record in every mode
    # (single-chip, user-sharded mesh, and dual item_sharded mesh)
    import json
    import os

    with open(os.path.join(res.out_dir, "metrics.jsonl")) as fh:
        events = [json.loads(line) for line in fh]
    serving = [e for e in events if e.get("event") == "serving"]
    assert serving and serving[-1]["recs_per_s"] > 0
