"""ORBvoc-scale BoW cost ON THE REAL CHIP (VERDICT r3 item 6): per-frame
tree descent + sparse-row build + loop-detection retrieval at the real
vocabulary scale (k=10, L=6, 10^6 words — `TemplatedVocabulary.h:
1471-1476`), vs the bench's 10^4-word trained vocabulary.

Run: python tools/bow_scale.py
"""
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax
from orbslam_mapsave_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable()
import jax.numpy as jnp
import numpy as np

from orbslam_mapsave_tpu.slammap import mapstate as ms
from orbslam_mapsave_tpu.vocab import database, vocabulary

N_FEAT = 2048
K_CAP = 64  # bench map capacity


def t(label, fn, rep=30):
    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    out = None
    for _ in range(rep):
        out = fn()
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / rep * 1e3
    print(f"{label:44s} {dt:8.2f} ms", flush=True)
    return dt


def main():
    print("building synthetic k=10 L=6 vocabulary (1.11M nodes)...",
          flush=True)
    t0 = time.perf_counter()
    voc = vocabulary.synthetic_full(k=10, L=6, seed=1)
    print(f"  built in {time.perf_counter()-t0:.1f}s; "
          f"n_nodes={voc.n_nodes} n_words={voc.n_words}", flush=True)

    transform = vocabulary.make_transform_packed(voc)
    tables_bytes = sum(int(np.asarray(x).nbytes) for x in transform.tables)
    print(f"  device tables: {tables_bytes/1e6:.1f} MB", flush=True)

    rng = np.random.default_rng(2)
    desc = jnp.asarray(rng.integers(0, 256, (N_FEAT, 32), dtype=np.uint8))
    valid = jnp.ones(N_FEAT, bool)

    m = N_FEAT  # sparse row capacity = feature count

    @jax.jit
    def bow_one(tables, d, v):
        out = transform.raw(*tables, d, v)
        return vocabulary.sparse_bow(out["word"], out["weight"], m)

    d_tf = t("descent+sparse_bow (1M words, 2048 feats)",
             lambda: bow_one(transform.tables, desc, valid))

    # retrieval against a full store of K_CAP keyframes
    store = database.empty_sparse_store(K_CAP, m)
    w, wt = bow_one(transform.tables, desc, valid)
    for k in range(K_CAP):
        store = database.add_keyframe_bow_sparse(store, k, w, wt)
    jax.block_until_ready(store)
    state = ms.empty_map(K_CAP, 1024, 64)

    from orbslam_mapsave_tpu.pipeline.loop_closing import _detect_device

    d_det = t("detect_device (sorted-merge join, K=64)",
              lambda: _detect_device(store, state, w, wt,
                                     jnp.asarray(3, jnp.int32)))

    # the bench's own 10^4-word scale for comparison
    voc_s = vocabulary.synthetic_full(k=10, L=4, seed=1)
    tf_s = vocabulary.make_transform_packed(voc_s)

    @jax.jit
    def bow_small(tables, d, v):
        out = tf_s.raw(*tables, d, v)
        return vocabulary.sparse_bow(out["word"], out["weight"], m)

    d_small = t("descent+sparse_bow (10k words, bench scale)",
                lambda: bow_small(tf_s.tables, desc, valid))

    out = {
        "orbvoc_descent_sparse_ms": round(d_tf, 2),
        "orbvoc_detect_ms": round(d_det, 2),
        "bench_scale_descent_ms": round(d_small, 2),
        "orbvoc_tables_mb": round(tables_bytes / 1e6, 1),
        "per_kf_extra_ms_at_orbvoc": round(d_tf - d_small, 2),
    }
    print(json.dumps(out), flush=True)
    (Path(__file__).resolve().parents[1] / "docs" /
     "BOW_SCALE.json").write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
