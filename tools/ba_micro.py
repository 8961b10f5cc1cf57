"""Time the pieces of the local BA program."""
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


def t(label, fn, n=20):
    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn()
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / n * 1000
    print(f"{label:44s} {dt:8.2f} ms")
    return dt


def main():
    rng = np.random.default_rng(0)
    C, L, E = 128, 4096, 16384

    # 768x768 SPD solve
    A = rng.standard_normal((C * 6, C * 6)).astype(np.float32)
    S = jnp.asarray(A @ A.T + np.eye(C * 6, dtype=np.float32) * C)
    b = jnp.asarray(rng.standard_normal(C * 6).astype(np.float32))
    solve = jax.jit(lambda S, b: jnp.linalg.solve(S, b))
    t("jnp.linalg.solve 768", lambda: solve(S, b))
    cho = jax.jit(lambda S, b: jax.scipy.linalg.cho_solve(
        jax.scipy.linalg.cho_factor(S), b))
    t("cho_solve 768", lambda: cho(S, b))

    def pcg(S, b, iters=25):
        Minv = 1.0 / jnp.diagonal(S)

        def body(carry, _):
            x, r, z, p, rz = carry
            Sp = S @ p
            alpha = rz / jnp.vdot(p, Sp)
            x = x + alpha * p
            r = r - alpha * Sp
            z = Minv * r
            rz_new = jnp.vdot(r, z)
            beta = rz_new / rz
            p = z + beta * p
            return (x, r, z, p, rz_new), None

        x = jnp.zeros_like(b)
        r = b
        z = Minv * r
        (x, *_), _ = jax.lax.scan(body, (x, r, z, z, jnp.vdot(r, z)), None,
                                  length=iters)
        return x

    pcg_j = jax.jit(pcg)
    t("pcg(25) 768", lambda: pcg_j(S, b))

    # U/V scatter + S einsum
    ecam = jnp.asarray(rng.integers(0, C, E), jnp.int32)
    ept = jnp.asarray(rng.integers(0, L, E), jnp.int32)
    blk = jnp.asarray(rng.standard_normal((E, 6, 3)).astype(np.float32))

    @jax.jit
    def scat_uv(ecam, ept, blk):
        U = jnp.zeros((C, L, 6, 3), jnp.float32).at[ecam, ept].add(blk)
        V = jnp.zeros((C, L, 6, 3), jnp.float32).at[ecam, ept].add(blk * 2)
        return U, V

    U, V = scat_uv(ecam, ept, blk)
    t("U/V scatter (E=16k -> C,L,6,3)", lambda: scat_uv(ecam, ept, blk))

    HI = jax.lax.Precision.HIGHEST

    @jax.jit
    def s_einsum(U, V):
        return jnp.einsum("clak,dlbk->cadb", U, V, precision=HI)

    t("S einsum (C,L,6,3)^2 HIGHEST", lambda: s_einsum(U, V))

    @jax.jit
    def s_einsum_def(U, V):
        return jnp.einsum("clak,dlbk->cadb", U, V)

    t("S einsum default prec", lambda: s_einsum_def(U, V))

    # edge terms cost: E edges of small math
    T = jnp.tile(jnp.eye(4, dtype=jnp.float32), (C, 1, 1))
    pts = jnp.asarray(rng.standard_normal((L, 3)).astype(np.float32) + 3)

    # one-hot reduction
    cam_flat = jnp.asarray(rng.standard_normal((E, 42)).astype(np.float32))

    @jax.jit
    def onehot_red(ecam, cam_flat):
        onehot = (ecam[:, None] == jnp.arange(C)[None, :]).astype(jnp.float32)
        return jnp.einsum("ec,ez->cz", onehot, cam_flat, precision=HI)

    t("one-hot cam reduction", lambda: onehot_red(ecam, cam_flat))


if __name__ == "__main__":
    main()
