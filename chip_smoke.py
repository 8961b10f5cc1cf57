"""Smoke test of the SLAM main path on one GPU, end to end.

    python chip_smoke.py           # one card: all phases below
    python chip_smoke.py --four    # four cards: the multi-device path only

Phases (one card), each through the entry points a user calls:

1. device: JAX must report a GPU; prints JAX's version, the device kind and
   count, and the card's name and power limit (nvidia-smi).
2. RGB-D loop at the reference operating point (bench.py's 240-frame
   circle, 640x480, 2000 ORB features, 4 levels at 1.5, K_cap 64, P_cap
   32768, vocabulary trained from the sequence with seed 1, loop closing
   on), through `SLAMSystem.track_rgbd`: asserts a loop event, a keyframe
   ATE bound and a lost-frame bound; prints compile seconds, the fps of one
   warm pass and peak device memory.
3. CLI and persistence: renders a 40-frame TUM sequence, runs the
   `run_slam` CLI fresh with --save-map, then again with --reuse-map;
   asserts both trajectories are written and the reuse run relocalizes.
4. kernels on the card against their plain references at real widths:
   the Triton pose-LM kernel vs the XLA schedule, the int8 Hamming matmul
   vs popcounts, ORB extraction vs the same function on the host CPU, and
   the exact bf16 row selects of ORB's BRIEF sampling.

`--four` runs phase 2 on four cards (the loop event's global BA shards over
them), the loop's map through the sharded full-map BA against the
single-device solver, the sharded BoW retrieval against a single-device
scoring of the same query, and prints the per-device bytes of the sharded
tables.

Every failure exits non-zero. The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
All work runs in this one process (one JAX client per card).
"""

import argparse
import json
import tempfile
import time
from pathlib import Path

import numpy as np

import bench

# Phase-2 bounds, fixed from runs of this sequence on H100s (kf ATE
# 0.0081-0.0091 m over the Triton and the XLA pose paths, one and four
# cards; 0 lost frames; 1 loop event each). They leave room for f32 sums in
# another order, not for a different trajectory.
ATE_BOUND_M = 0.03
LOST_BOUND = 3
# The dist-vs-single GBA tolerances of __graft_entry__.dryrun_multichip:
# the sharded PCG sums in another order and stops on its own residual.
GBA_COST_RTOL = 0.05
GBA_POSE_ATOL = 5e-2


def say(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def check_device(n_expected: int = 1) -> dict:
    """Phase 1. Exits non-zero unless JAX's default backend is a GPU."""
    import jax

    dev = bench.describe_device(allow_cpu=False)
    require(dev["count"] >= n_expected,
            f"needs {n_expected} GPUs, JAX sees {dev['count']}")
    say(f"[device] jax {jax.__version__} platform={dev['platform']} "
        f"kind={dev['kind']} count={dev['count']}")
    say(dev["nvidia_smi"])
    return dev


class CompileTimer:
    """Sums XLA backend compile time (cache retrievals included) between
    construction and `stop()`."""

    EVENT = "/jax/core/compile/backend_compile_duration"

    def __init__(self):
        import jax

        self.seconds = 0.0
        self.count = 0
        self._monitoring = jax.monitoring
        self._monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_):
        if event == self.EVENT:
            self.seconds += duration
            self.count += 1

    def stop(self):
        self._monitoring.unregister_event_duration_listener(self._on)


def phase_loop(tag: str = "loop") -> tuple[object, dict]:
    """Phase 2: the bench loop, one cold and one warm pass on one system."""
    import jax

    from orbslam_mapsave_tpu import config as config_mod
    from orbslam_mapsave_tpu.pipeline import system as system_mod

    t0 = time.perf_counter()
    data = bench.get_sequence()
    voc = bench.get_vocabulary(data, config_mod, system_mod)
    slam = bench.make_system(voc, config_mod, system_mod)
    frames_dev = bench.stage_frames(data)
    say(f"[{tag}] setup {time.perf_counter() - t0:.1f}s "
        f"(sequence, vocabulary {voc.n_words} words)")

    timer = CompileTimer()
    cold_s, _ = bench.run_pass(slam, frames_dev)
    cold_compiles = (timer.seconds, timer.count)
    slam.reset()
    timer.seconds, timer.count = 0.0, 0
    warm_s, frame_ms = bench.run_pass(slam, frames_dev)
    timer.stop()
    q = bench.trajectory_quality(slam, data)
    stats = jax.devices()[0].memory_stats() or {}  # None off-GPU
    say(f"[{tag}] cold pass {cold_s:.1f}s, compile {cold_compiles[0]:.1f}s "
        f"in {cold_compiles[1]} programs")
    say(f"[{tag}] warm pass {bench.N_FRAMES / warm_s:.2f} fps "
        f"(wall {warm_s:.2f}s, frame p50 {np.percentile(frame_ms, 50):.2f} ms"
        f" p99 {np.percentile(frame_ms, 99):.2f} ms), {timer.count} "
        f"compiles inside it")
    say(f"[{tag}] peak device memory "
        f"{stats.get('peak_bytes_in_use', float('nan')) / 2**30:.2f} GiB "
        f"(device 0 peak_bytes_in_use)")
    say(f"[{tag}] kfs={q['kfs']} pts={q['pts']} loops={q['loops']} "
        f"lost={q['lost']} kf_ate={q['kf_ate']:.4f} m")
    require(q["loops"] >= 1, f"no loop event fired ({q})")
    require(q["kf_ate"] < ATE_BOUND_M,
            f"keyframe ATE {q['kf_ate']:.4f} m >= bound {ATE_BOUND_M} m")
    require(q["lost"] <= LOST_BOUND,
            f"{q['lost']} lost frames > bound {LOST_BOUND}")
    return slam, q


def phase_cli(workdir: Path, n_frames: int = 40, width: int = 640,
              height: int = 480) -> dict:
    """Phase 3: run_slam fresh with --save-map, then with --reuse-map."""
    from orbslam_mapsave_tpu.apps import run_slam
    from orbslam_mapsave_tpu.io import synthetic
    from orbslam_mapsave_tpu.io import trajectory as traj_io
    from orbslam_mapsave_tpu.pipeline import tracking

    fx = 520.0 * width / 640  # the bench camera's field of view
    K = np.array([[fx, 0, width / 2], [0, fx, height / 2], [0, 0, 1.0]])
    seq = synthetic.write_tum_sequence(
        workdir / "tum", K, synthetic.orbit_trajectory(n_frames), width,
        height, seed=3)
    cam_yaml = workdir / "camera.yaml"
    cam_yaml.write_text(
        "%YAML:1.0\n"
        f"Camera.fx: {fx}\nCamera.fy: {fx}\n"
        f"Camera.cx: {width / 2}\nCamera.cy: {height / 2}\n"
        f"Camera.width: {width}\nCamera.height: {height}\n"
        "Camera.fps: 30.0\n"
        f"Camera.bf: {fx * 0.08}\nThDepth: 50.0\nDepthMapFactor: 5000.0\n"
        "ORBextractor.nFeatures: 2000\nORBextractor.scaleFactor: 1.5\n"
        "ORBextractor.nLevels: 4\nORBextractor.iniThFAST: 15\n"
        "ORBextractor.minThFAST: 3\n")
    common = ["--dataset", str(seq), "--sensor", "rgbd",
              "--camera-yaml", str(cam_yaml)]
    map_path = workdir / "map.npz"
    out = {}
    for run, extra in (("fresh", ["--save-map", str(map_path)]),
                       ("reuse", ["--reuse-map", str(map_path)])):
        traj = workdir / f"{run}_traj.txt"
        kf_traj = workdir / f"{run}_kf.txt"
        t0 = time.perf_counter()
        slam = run_slam.main(common + extra + ["--out", str(traj),
                                               "--kf-out", str(kf_traj)])
        wall = time.perf_counter() - t0
        require(traj.is_file() and kf_traj.is_file(),
                f"{run}: trajectories not written")
        n_lines = len(traj.read_text().splitlines())
        n_ok = sum(1 for (_, _, lost) in slam.tracker.trajectory if not lost)
        gt_ts, gt = traj_io.load_tum_trajectory(seq / "groundtruth.txt")
        et, est = traj_io.load_tum_trajectory(traj)
        ate = traj_io.ate_rmse(gt_ts, gt, et * 1e3, est) if len(et) else \
            float("nan")
        out[run] = {"wall_s": wall, "tracked": n_ok, "traj_lines": n_lines,
                    "ate": ate, "state": slam.tracker.state}
        say(f"[cli] {run}: {wall:.1f}s, {n_ok}/{n_frames} frames tracked, "
            f"{n_lines} trajectory lines, ATE {ate:.4f} m")
        require(n_lines > 0, f"{run}: empty camera trajectory")
    require(map_path.is_file(), "--save-map wrote no map")
    require(out["reuse"]["tracked"] > 0
            and out["reuse"]["state"] == tracking.OK,
            f"reuse run never relocalized ({out['reuse']})")
    return out


def _pose_problem(M: int, seed: int = 7):
    import jax.numpy as jnp

    from orbslam_mapsave_tpu.geometry import projection, se3
    from orbslam_mapsave_tpu.optim import pose_opt

    rng = np.random.default_rng(seed)
    cam = projection.Camera.create(520.0, 520.0, 320.0, 240.0, bf=41.6,
                                   width=640, height=480)
    pts = rng.uniform([-2, -2, 1.5], [2, 2, 6], (M, 3)).astype(np.float32)
    xi = np.array([0.04, -0.02, 0.03, 0.012, -0.018, 0.01], np.float32)
    T = np.asarray(se3.se3_exp(jnp.asarray(xi)))
    pc = pts @ T[:3, :3].T + T[:3, 3]
    uv = np.stack([520 * pc[:, 0] / pc[:, 2] + 320,
                   520 * pc[:, 1] / pc[:, 2] + 240], -1)
    uv = (uv + rng.normal(0, 0.5, uv.shape)).astype(np.float32)
    out = rng.random(M) < 0.1
    uv[out] += rng.uniform(20, 60, (out.sum(), 2)).astype(np.float32)
    ur = np.full(M, -1.0, np.float32)
    st = rng.random(M) < 0.3
    ur[st] = (uv[st, 0] - 41.6 / pc[st, 2]).astype(np.float32)
    obs = pose_opt.PoseObs(
        pt_w=jnp.asarray(pts), uv=jnp.asarray(uv), ur=jnp.asarray(ur),
        inv_sigma2=jnp.ones(M, jnp.float32),
        valid=jnp.asarray(rng.random(M) > 0.05))
    return cam, obs, T


def check_pose_kernel(M: int) -> dict:
    """Triton pose-LM kernel vs `pose_optimization_xla` on one problem.

    Tolerance: pose entries within 1e-4 and at most 0.5% of edges classified
    differently. Both run f32 on the same device, but the kernel's block
    reductions sum in another order than XLA's and Triton divides with
    `div.full.f32` (2 ulp); the LM accept test can then resolve a
    near-tie differently, which moves the pose by far less than 1e-4 and
    flips only edges whose chi2 sits on the gate."""
    import jax
    import jax.numpy as jnp

    from orbslam_mapsave_tpu.optim import pose_opt, pose_opt_pallas

    cam, obs, T = _pose_problem(M)
    pose0 = jnp.eye(4, dtype=jnp.float32)
    ref = jax.device_get(pose_opt.pose_optimization_xla(cam, pose0, obs))
    got = jax.device_get(pose_opt_pallas.pose_optimization_pallas(
        cam, pose0, obs))
    res = {
        "pose_err": float(np.abs(ref[0] - got[0]).max()),
        "inlier_diff": int((ref[1] != got[1]).sum()),
        "n_ref": int(ref[2]), "n_kernel": int(got[2]),
        "true_err": float(np.abs(got[0] - T).max()),
    }
    require(res["pose_err"] < 1e-4, f"pose kernel M={M}: {res}")
    require(res["inlier_diff"] <= 0.005 * M, f"pose kernel M={M}: {res}")
    require(res["true_err"] < 5e-3, f"pose kernel M={M}: {res}")
    return res


def check_hamming(n: int = 2048, seed: int = 0) -> None:
    """int8 x int8 -> int32 Hamming matmul vs popcounts: exact."""
    import jax
    import jax.numpy as jnp

    from orbslam_mapsave_tpu.ops import hamming

    rng = np.random.default_rng(seed)
    a = jnp.asarray(rng.integers(0, 256, (n, 32), dtype=np.uint8))
    b = jnp.asarray(rng.integers(0, 256, (n, 32), dtype=np.uint8))
    got = jax.jit(hamming.hamming_matrix)(a, b)
    ref = jax.jit(jax.vmap(
        lambda r: hamming.hamming_vec(jnp.broadcast_to(r, b.shape), b)))(a)
    require(bool(jnp.array_equal(got, ref)),
            f"hamming_matrix != popcount at {n}x{n}")


def _brief_ref(patches: np.ndarray, quarter_turns: np.ndarray) -> np.ndarray:
    """Plain BRIEF-256 sampling of (C,43,43) patches at angles that are
    multiples of 90 degrees (integer rotations, no rounding ambiguity)."""
    from orbslam_mapsave_tpu.ops import orb

    pat = np.asarray(orb.BIT_PATTERN_31, np.int64)
    px = np.concatenate([pat[:, 0], pat[:, 2]])
    py = np.concatenate([pat[:, 1], pat[:, 3]])
    th = np.radians(90.0 * quarter_turns)
    a = np.rint(np.cos(th)).astype(np.int64)[:, None]
    b = np.rint(np.sin(th)).astype(np.int64)[:, None]
    col = px[None] * a - py[None] * b + orb.DESC_PAD
    row = px[None] * b + py[None] * a + orb.DESC_PAD
    c = np.arange(patches.shape[0])[:, None]
    vals = patches[c, row, col]
    bits = (vals[:, :256] < vals[:, 256:]).astype(np.uint8)
    return np.packbits(bits.reshape(-1, 32, 8), axis=-1,
                       bitorder="little").reshape(-1, 32)


def check_orb_exact(n_kp: int = 2048, height: int = 480, width: int = 640,
                    seed: int = 0) -> None:
    """The bf16 one-hot selects of ORB must be exact on the device."""
    import jax
    import jax.numpy as jnp

    from orbslam_mapsave_tpu.ops import orb

    rng = np.random.default_rng(seed)
    E, D, r = orb.EDGE, orb.DESC_PAD, orb.DESC_PAD + 3
    Hp, Wp = height + 2 * E, width + 2 * E
    # two-channel patch cut: integer stack, bf16 row gather + one-hot
    stack = rng.integers(0, 256, (2, Hp, Wp)).astype(np.float32)
    xy = np.stack([rng.integers(r, width - r, n_kp),
                   rng.integers(r, height - r, n_kp)], -1).astype(np.int32)
    got = np.asarray(jax.jit(orb.cut_patches_2ch)(
        jnp.asarray(stack), jnp.asarray(xy))).astype(np.float32)
    y0 = xy[:, 1] + E - r
    x0 = xy[:, 0] + E - r
    idx = np.arange(orb.PATCH49)
    ref = stack[:, (y0[:, None] + idx)[:, :, None],
                (x0[:, None] + idx)[:, None, :]].transpose(1, 0, 2, 3)
    require(np.array_equal(got, ref), "cut_patches_2ch is not exact")
    # BRIEF sampling from integer patches: bf16 row select, bf16 sums
    turns = rng.integers(0, 4, n_kp)
    W43 = 2 * D + 1
    patches = rng.integers(0, 256, (n_kp, W43, W43)).astype(np.float32)
    got = np.asarray(jax.jit(orb.brief_from_patches)(
        jnp.asarray(patches), jnp.asarray(90.0 * turns, jnp.float32)))
    require(np.array_equal(got, _brief_ref(patches, turns)),
            "brief_from_patches is not exact")
    # BRIEF sampling from a whole image through the bf16 hi/lo split: values
    # on a 1/64 grid below 256 have at most 14 significant bits, which
    # hi + lo (8 + 8 bits) represent exactly
    blurred = rng.integers(0, 256 * 64, (Hp, Wp)).astype(np.float32) / 64
    got = np.asarray(jax.jit(orb.brief_descriptors)(
        jnp.asarray(blurred), jnp.asarray(xy),
        jnp.asarray(90.0 * turns, jnp.float32)))
    ys = (xy[:, 1] + E - D)[:, None, None] + np.arange(W43)[None, :, None]
    xs = (xy[:, 0] + E - D)[:, None, None] + np.arange(W43)[None, None, :]
    require(np.array_equal(got, _brief_ref(blurred[ys, xs], turns)),
            "brief_descriptors (hi/lo split) is not exact")


def check_orb_vs_cpu(image: np.ndarray) -> dict:
    """ORB extraction on the card vs the same function jitted on the host
    CPU, at the reference operating point. Reports agreement; requires 90%
    of keypoints and of their descriptors to agree (FAST scores, the
    resize matmuls and the blur sum in another order on the two backends,
    which can reorder near-equal responses at a level's budget cut)."""
    import functools

    import jax
    import jax.numpy as jnp

    from orbslam_mapsave_tpu.ops import hamming, orb

    h, w = image.shape
    spec = orb.ORBSpec.create(h, w, n_features=2000, n_levels=4,
                              scale_factor=1.5, max_kp=2048)
    run = jax.jit(functools.partial(orb.extract, spec))
    img = jnp.asarray(image, jnp.float32)
    gpu = jax.device_get(run(img))
    cpu = jax.device_get(run(jax.device_put(img, jax.devices("cpu")[0])))

    def keyed(k):
        return {(float(k["xy"][i, 0]), float(k["xy"][i, 1]),
                 int(k["octave"][i])): i for i in np.nonzero(k["valid"])[0]}

    kg, kc = keyed(gpu), keyed(cpu)
    common = sorted(set(kg) & set(kc))
    dg = np.stack([gpu["desc"][kg[c]] for c in common])
    dc = np.stack([cpu["desc"][kc[c]] for c in common])
    dist = np.asarray(hamming.hamming_vec(jnp.asarray(dg), jnp.asarray(dc)))
    res = {"kp_gpu": len(kg), "kp_cpu": len(kc),
           "kp_shared": len(common) / max(len(kg), len(kc), 1),
           "desc_equal": float((dist == 0).mean()),
           "desc_mean_bits": float(dist.mean())}
    require(res["kp_shared"] >= 0.9 and res["desc_equal"] >= 0.9,
            f"ORB card vs CPU: {res}")
    return res


def phase_kernels(image: np.ndarray) -> None:
    """Phase 4."""
    for M in (2048, 1500):
        say(f"[kernels] pose LM M={M}: {check_pose_kernel(M)}")
    check_hamming(2048)
    say("[kernels] hamming 2048x2048: exact")
    check_orb_exact()
    say("[kernels] ORB cut_patches_2ch / brief_from_patches / "
        "brief_descriptors: exact")
    say(f"[kernels] ORB 640x480 card vs CPU: {check_orb_vs_cpu(image)}")


def _device_bytes(tree) -> dict:
    import jax

    out = {}
    for x in jax.tree.leaves(tree):
        for s in getattr(x, "addressable_shards", []):
            out[str(s.device)] = out.get(str(s.device), 0) + s.data.nbytes
    return out


def phase_four(slam) -> None:
    """--four: the loop's map and BoW store through the sharded solvers."""
    import jax
    import jax.numpy as jnp

    from orbslam_mapsave_tpu.optim import global_ba
    from orbslam_mapsave_tpu.parallel import dist_gba, dist_reloc
    from orbslam_mapsave_tpu.vocab import database

    n = len(jax.devices())
    state = slam.map
    isig = jnp.asarray(slam.builder.inv_level_sigma2)
    mesh = dist_gba.make_mesh(n)
    sharded = dist_gba.shard_map_state(state, mesh)
    for dev, nbytes in sorted(_device_bytes(sharded).items()):
        say(f"[four] sharded map on {dev}: {nbytes / 2**20:.1f} MiB")
    p_d, _, c_d = dist_gba.distributed_full_ba(
        slam.cam, sharded, isig, mesh, n_iters=10, cg_iters=100)
    p_1, _, c_1 = global_ba.full_bundle_adjustment(
        slam.cam, state, isig, n_iters=10, cg_iters=100)
    c_d, c_1 = float(c_d), float(c_1)
    n_kf = int(state.n_kf)
    perr = float(np.abs(np.asarray(p_d)[:n_kf] - np.asarray(p_1)[:n_kf])
                 .max())
    say(f"[four] GBA over {n} devices: cost {c_d:.4f} vs single-device "
        f"{c_1:.4f}, pose err {perr:.2e} ({n_kf} keyframes)")
    require(abs(c_d - c_1) <= GBA_COST_RTOL * max(abs(c_1), 1e-6),
            f"sharded GBA cost {c_d} vs {c_1}")
    require(perr < GBA_POSE_ATOL, f"sharded GBA pose err {perr}")

    store = slam.loop_closer.bow_store
    top_k = slam.tracker.relocalizer.max_candidates
    sstore = dist_reloc.shard_store(store, mesh)
    for dev, nbytes in sorted(_device_bytes(sstore).items()):
        say(f"[four] sharded BoW store on {dev}: {nbytes / 2**10:.1f} KiB")
    query = dist_reloc.make_distributed_query(mesh, top_k=top_k)
    kf_valid = np.asarray(state.kf_valid)
    K = kf_valid.shape[0]
    blk = K // n
    for q in np.nonzero(kf_valid)[0][::7]:
        q_word, q_weight = store.word[q], store.weight[q]
        slots, scores = jax.device_get(
            query(sstore, state.kf_valid, q_word, q_weight))
        got = {int(s): float(v) for s, v in zip(slots, scores) if s >= 0}
        # single-device reference: the same gates over the whole store,
        # then each keyframe block's top_k
        common, sc = jax.device_get(
            database._sparse_common_and_scores(store, q_word, q_weight))
        common = np.where(kf_valid, common, 0)
        ok = kf_valid & (common > int(0.8 * common.max()))
        acc = np.where(ok, sc, 0.0)
        keep = ok & (acc > 0.75 * acc[ok].max())
        ref = {}
        for b in range(n):
            rows = np.nonzero(keep[b * blk:(b + 1) * blk])[0] + b * blk
            for r in rows[np.argsort(-sc[rows], kind="stable")][:top_k]:
                ref[int(r)] = float(sc[r])
        require(set(got) == set(ref),
                f"reloc query {q}: sharded {sorted(got)} vs {sorted(ref)}")
        require(all(abs(got[k] - ref[k]) < 1e-5 for k in ref),
                f"reloc query {q}: scores differ")
        require(int(q) in got, f"reloc query {q}: true match missing")
    say(f"[four] sharded BoW retrieval matches the single-device query "
        f"({len(np.nonzero(kf_valid)[0][::7])} queries, top_k {top_k})")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card path and its comparison")
    args = ap.parse_args(argv)
    n = 4 if args.four else 1
    dev = check_device(n)
    if args.four:
        slam, _ = phase_loop("four")
        phase_four(slam)
    else:
        phase_loop()
        with tempfile.TemporaryDirectory() as tmp:
            phase_cli(Path(tmp))
        phase_kernels(bench.get_sequence()["frames"][0][0])
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}), flush=True)


if __name__ == "__main__":
    main()
