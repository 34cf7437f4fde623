#!/usr/bin/env python
"""Per-row random-access primitive microbench, dtype-resolved.

Times, per dtype, every primitive the BPR/SGD epochs issue — gather,
scatter-add, segment_sum (sorted/unsorted) — at the exact row widths
those epochs use (rank+2 fused columns), plus the int32 bits-word gather
of the BPR collision mask.

Method: ITERS repetitions INSIDE one lax.scan (dispatch amortized), timed
to jax.block_until_ready; each measurement reports ns per indexed row.
"""

import argparse
import json
import time

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax


def sync(x):
    return jax.block_until_ready(x)


def timed(fn, *args, iters=3):
    fn(*args)  # compile
    best = float("inf")
    for _ in range(iters):
        t0 = time.time()
        out = fn(*args)
        sync(out if isinstance(out, jax.Array) else out[0])
        best = min(best, time.time() - t0)
    return best


def scan_op(body, carry, steps):
    @jax.jit
    def run(carry):
        return lax.scan(lambda c, _: (body(c), None), carry,
                        None, length=steps)[0]
    return run


def bench_gather(n, b, w, dt, steps, key):
    idx = jax.random.randint(key, (b,), 0, n, jnp.int32)
    T = jnp.ones((n, w), dt)

    def body(c):
        s, T = c
        g = T[idx]
        return s + g[:, 0].astype(jnp.float32).sum(), T

    run = scan_op(body, (jnp.float32(0), T), steps)
    dt_s = timed(lambda c: run(c)[0], (jnp.float32(0), T))
    return dt_s / steps / b * 1e9


def bench_scatter(n, b, w, dt, steps, key, sorted_idx=False, seg=False):
    idx = jax.random.randint(key, (b,), 0, n, jnp.int32)
    if sorted_idx:
        idx = jnp.sort(idx)
    rows = jnp.ones((b, w), dt)
    T = jnp.zeros((n, w), dt)

    if seg:
        def body(T):
            d = jax.ops.segment_sum(rows, idx, num_segments=n,
                                    indices_are_sorted=sorted_idx)
            return T + d
    else:
        def body(T):
            return T.at[idx].add(rows)

    run = scan_op(body, T, steps)
    dt_s = timed(run, T)
    return dt_s / steps / b * 1e9


def bench_bits_gather(n_users, n_words, b, steps, key):
    k1, k2 = jax.random.split(key)
    bits = jnp.zeros((n_users, n_words), jnp.uint32)
    ub = jax.random.randint(k1, (b,), 0, n_users, jnp.int32)
    jb = jax.random.randint(k2, (b,), 0, n_words * 32, jnp.int32)

    def body(s):
        word = bits[ub, jb // 32]
        hit = (word >> (jb % 32).astype(jnp.uint32)) & jnp.uint32(1)
        return s + hit.astype(jnp.float32).sum()

    run = scan_op(body, jnp.float32(0), steps)
    dt_s = timed(run, jnp.float32(0))
    return dt_s / steps / b * 1e9


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=65536)
    ap.add_argument("--steps", type=int, default=200)
    args = ap.parse_args()
    b, steps = args.batch, args.steps
    key = jax.random.key(0)
    print(json.dumps({"device": str(jax.devices()[0]), "batch": b,
                      "steps": steps}))
    shapes = [
        # (label, table rows, row width)
        ("V@ml20m", 26_745, 34),
        ("V@ml20m", 26_745, 66),
        ("V@netflix", 17_771, 34),
        ("U-tile", 680, 34),
        ("U@ml20m", 138_494, 34),
    ]
    for dt, dn in ((jnp.float32, "f32"), (jnp.bfloat16, "bf16")):
        for label, n, w in shapes:
            g = bench_gather(n, b, w, dt, steps, key)
            sc = bench_scatter(n, b, w, dt, steps, key)
            ss = bench_scatter(n, b, w, dt, steps, key, seg=True)
            sss = bench_scatter(n, b, w, dt, steps, key, sorted_idx=True,
                                seg=True)
            print(json.dumps({"table": label, "rows": n, "width": w,
                              "dtype": dn,
                              "gather_ns": round(g, 2),
                              "scatter_add_ns": round(sc, 2),
                              "segsum_ns": round(ss, 2),
                              "segsum_sorted_ns": round(sss, 2)}),
                  flush=True)
    bg = bench_bits_gather(138_494, 836, b, steps, key)
    print(json.dumps({"op": "bits_word_gather", "ns": round(bg, 2)}))


if __name__ == "__main__":
    main()
