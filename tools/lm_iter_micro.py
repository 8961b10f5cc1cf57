"""Latency of one dependent LM iteration and its pieces, realistic shapes."""
import os
import sys
import time
from functools import partial
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax
from orbslam_mapsave_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable()
import jax.numpy as jnp
import numpy as np

from orbslam_mapsave_tpu.geometry import projection
from orbslam_mapsave_tpu.optim import local_ba as lb


def mk_problem(rng, C=128, L=4096, O=32, E=16384):
    pose = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    pose[:, :3, 3] = rng.standard_normal((C, 3)) * 0.1
    pts = rng.standard_normal((L, 3)).astype(np.float32)
    pts[:, 2] += 5.0
    obs_cam = rng.integers(0, C, (L, O)).astype(np.int32)
    obs_valid = rng.random((L, O)) < (E / (L * O))
    prob = lb.BAProblem(
        cam_pose=jnp.asarray(pose),
        cam_fixed=jnp.asarray(np.arange(C) >= C // 2),
        cam_valid=jnp.ones(C, bool),
        pt_pos=jnp.asarray(pts),
        pt_valid=jnp.ones(L, bool),
        obs_cam=jnp.asarray(obs_cam),
        obs_uv=jnp.asarray(rng.standard_normal((L, O, 2)).astype(np.float32) * 100 + 300),
        obs_ur=jnp.full((L, O), -1.0, jnp.float32),
        obs_inv_sigma2=jnp.ones((L, O), jnp.float32),
        obs_valid=jnp.asarray(obs_valid),
    )
    return prob


def t(label, fn, n=5):
    o = fn()
    jax.block_until_ready(o)
    t0 = time.perf_counter()
    for _ in range(n):
        o = fn()
    jax.block_until_ready(o)
    print(f"{label:44s} {(time.perf_counter()-t0)/n*1000:8.2f} ms")


def main():
    rng = np.random.default_rng(0)
    cam = projection.Camera.create(520.0, 520.0, 320.0, 240.0, bf=40.0,
                                   width=640, height=480)
    prob = mk_problem(rng)
    E = 16384
    e = lb._compact_edges(prob, E)
    e = jax.tree.map(jnp.asarray, e)
    jax.block_until_ready(e)

    # full solve as shipped
    f_full = jax.jit(lambda: lb.local_bundle_adjustment(cam, prob))
    t("local_bundle_adjustment (5+10)", f_full, n=3)

    # one dependent chain of k build_and_solve
    def chain(k):
        @jax.jit
        def run():
            def body(carry, _):
                poses, pts = carry
                dxc, dxp = lb._build_and_solve(
                    cam, poses, pts, prob, e, e.ok, jnp.asarray(True),
                    jnp.asarray(1e-4, jnp.float32))
                from orbslam_mapsave_tpu.geometry import se3
                poses = se3.se3_exp(dxc * 0.0001) @ poses
                return (poses, pts + dxp * 0.0001), None
            (p, q), _ = jax.lax.scan(body, (prob.cam_pose, prob.pt_pos),
                                     None, length=k)
            return p, q
        return run

    f1 = chain(1)
    f10 = chain(10)
    t("1x build_and_solve", f1, n=5)
    t("10x build_and_solve chain", f10, n=3)

    # pieces in a dependent chain of 10
    poses0, pts0 = prob.cam_pose, prob.pt_pos

    def piece_chain(piece, k=10):
        @jax.jit
        def run():
            def body(carry, _):
                pts = carry
                out = piece(pts)
                return pts + out * 1e-9, None
            q, _ = jax.lax.scan(body, pts0, None, length=k)
            return q
        return run

    C = 128
    L = 4096

    def p_edge_terms(pts):
        r, Jc, Jp, chi2, ok_z, is_st = lb._edge_terms_e(cam, poses0, pts, e, e.ok)
        return jnp.sum(r) * jnp.ones(3) + pts * 0

    def p_uv_scatter(pts):
        w = jnp.ones(E, jnp.float32)
        blk = jnp.broadcast_to(pts[e.pt][:, :, None], (E, 3, 6)).transpose(0, 2, 1)
        U = jnp.zeros((C, L, 6, 3), jnp.float32).at[e.cam, e.pt].add(blk)
        return jnp.sum(U) + pts * 0

    def p_s_einsum(pts):
        blk = jnp.broadcast_to(pts[e.pt][:, :, None], (E, 3, 6)).transpose(0, 2, 1)
        U = jnp.zeros((C, L, 6, 3), jnp.float32).at[e.cam, e.pt].add(blk)
        S = jnp.einsum("clak,dlbk->cadb", U, U, precision=jax.lax.Precision.HIGHEST)
        return jnp.sum(S) + pts * 0

    def p_solve(pts):
        S = jnp.eye(C * 6) * (1.0 + jnp.sum(pts) * 1e-12)
        x = jnp.linalg.solve(S, jnp.ones(C * 6))
        return jnp.sum(x) + pts * 0

    def p_cost(pts):
        return lb._cost_at(cam, poses0, pts, e, e.ok, jnp.asarray(True)) + pts * 0

    t("10x edge_terms chain", piece_chain(p_edge_terms), n=3)
    t("10x U scatter chain", piece_chain(p_uv_scatter), n=3)
    t("10x scatter+S-einsum chain", piece_chain(p_s_einsum), n=3)
    t("10x solve(768) chain", piece_chain(p_solve), n=3)
    t("10x cost_at chain", piece_chain(p_cost), n=3)


if __name__ == "__main__":
    main()
