"""Microbench: triangle-attribute gather strategies vs table size.

shade_hit picks between per-column gathers and one packed-row gather by
table size (ops/intersect.py, 64 rows). This tool measures both forms
(and a chunked one-hot matmul) across table sizes on the device, the
evidence that threshold needs (ROADMAP D3).
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

N = 960_000
K = 20


def fetch(x):
    return float(np.asarray(jnp.sum(x)))


LOOP = 20


def timed(f, *a):
    """Time LOOP in-jit repetitions (fori_loop) to amortize dispatch
    latency; returns seconds per repetition."""
    @jax.jit
    def many(*a):
        def body(i, acc):
            return acc + jnp.sum(f(*a) + acc * 0.0)
        return jax.lax.fori_loop(0, LOOP, body, jnp.float32(0))

    fetch(many(*a))
    t0 = time.time()
    fetch(many(*a))
    return (time.time() - t0) / LOOP


for T in (64, 512, 2308, 16384, 100_000):
    key = jax.random.PRNGKey(0)
    table = jax.random.normal(key, (T, K), jnp.float32)
    idx = jax.random.randint(jax.random.PRNGKey(1), (N,), 0, T, jnp.int32)

    @jax.jit
    def per_column(table, idx):
        return sum(table[:, j][idx] for j in range(K))

    @jax.jit
    def row_gather(table, idx):
        return table[idx].sum(axis=1)

    @jax.jit
    def onehot_chunked(table, idx, chunk=512):
        acc = jnp.zeros((N,), jnp.float32)
        tsum = table.sum(axis=1)        # [T]
        for lo in range(0, T, chunk):
            hi = min(lo + chunk, T)
            oh = (idx[:, None] == jnp.arange(lo, hi)[None, :])
            acc = acc + oh.astype(jnp.float32) @ tsum[lo:hi]
        return acc

    r = {}
    r["col"] = timed(per_column, table, idx)
    r["row"] = timed(row_gather, table, idx)
    if T <= 16384:
        r["onehot"] = timed(onehot_chunked, table, idx)
    msg = f"T={T:7d}: " + "  ".join(
        f"{k}={v * 1e3:7.2f} ms ({v / N * 1e9:5.2f} ns/lane)"
        for k, v in r.items())
    print(msg, flush=True)
