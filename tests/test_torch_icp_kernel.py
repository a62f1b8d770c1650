"""PyTorch port, the tracker's device-independent arithmetic on the CPU:
ICP's kernel (ops/cuda/icp_kernel.py) through its plain version against
the jitted JAX `_icp_level`, the plain version's bits against the thread
count, its sums against the kernel's order written out in float32
scalars, the CUDA source's constants against the plain version's, the
restated `_prep` against the jitted JAX `_prep` bit for bit (ROADMAP
Queue 3's fault), the pose graph, the descriptor and the match against
the thread count, and utils/parting.py's lockstep walk.  Inputs come from
numpy seeds; each assert states its tolerance."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disinfect_slam_tpu.core.geometry import CameraIntrinsics as JIntr
from disinfect_slam_tpu.core.geometry import CameraParams as JCam
from disinfect_slam_tpu.systems import odometry as jodo
from disinfect_slam_tpu_torch.core import exact
from disinfect_slam_tpu_torch.core.geometry import CameraIntrinsics
from disinfect_slam_tpu_torch.ops.cuda import icp_kernel
from disinfect_slam_tpu_torch.systems import loop_closure as tlc
from disinfect_slam_tpu_torch.systems import odometry as todo
from disinfect_slam_tpu_torch.utils import parting

from .scenes import look_at
from .test_odometry import H, K, W, scene_depth

torch.set_num_threads(1)

SOURCE = os.path.join(os.path.dirname(__file__), "..", "disinfect_slam_tpu_torch", "csrc",
                      "icp_step.cu")
P0 = look_at((0.0, 0.0, -0.5), (0.0, 0.0, 1.6))
MOVES = {"translation": look_at((0.02, 0.01, -0.49), (0.0, 0.0, 1.6)),
         "rotation": look_at((0.0, 0.0, -0.5), (0.05, 0.02, 1.6))}


def t(a):
    return torch.from_numpy(np.array(a))


def _level_inputs(move, seed):
    """One pyramid level's inputs (the JAX package's maps) for the scene
    seen from P0 and from `move`, the seed pose perturbed by a seeded 1 cm."""
    rng = np.random.default_rng(seed)
    jc = JCam.create(JIntr.create(*K), H, W)
    ref_v = np.asarray(jodo.vertex_map(jnp.asarray(scene_depth(P0)), jc))
    ref_n = np.asarray(jodo.normal_map(jnp.asarray(ref_v)))
    cur_v = np.asarray(jodo.vertex_map(jnp.asarray(scene_depth(MOVES[move])), jc))
    wtc = np.linalg.inv(P0)
    rw = (ref_v @ wtc[:3, :3].T + wtc[:3, 3]).astype(np.float32)
    nw = (ref_n @ wtc[:3, :3].T).astype(np.float32)
    T0 = np.linalg.inv(MOVES[move]).astype(np.float32)
    T0[:3, 3] += rng.normal(0, 0.01, 3).astype(np.float32)
    return T0, cur_v, rw, nw, scene_depth(P0) > 0, P0.astype(np.float32)


def _pack(rw, nw, valid):
    n = valid.size
    return torch.cat([t(rw).reshape(-1, 3), t(nw).reshape(-1, 3),
                      t(valid).reshape(-1, 1).float(), torch.zeros((n, 1))], 1)


@pytest.mark.parametrize("move", sorted(MOVES))
@pytest.mark.parametrize("seed", [3, 11])
def test_icp_step_reference_matches_the_jitted_jax_level(move, seed):
    """icp_step_reference iterated 6 times against the jitted JAX
    _icp_level on the same level: world_T_cam within 2e-6
    (tests/test_torch_odometry.py's limit: the float32 sums' rounding),
    rmse within 1e-5 relative, the same inlier count."""
    T0, cur_v, rw, nw, valid, ref_pose = _level_inputs(move, seed)
    jc = JCam.create(JIntr.create(*K), H, W)
    Tj, rj, ij = jax.jit(lambda a, b, c, d, e, f: jodo._icp_level(
        a, b, c, d, e, jc, f, 6, 0.25, 0.05))(*(jnp.asarray(x) for x in (
            T0, cur_v, rw, nw, valid, ref_pose)))
    c = CameraIntrinsics.create(*K)
    intr = (c.fx, c.fy, c.cx, c.cy)
    T, pack, src = t(T0), _pack(rw, nw, valid), t(cur_v).reshape(-1, 3)
    for _ in range(6):
        T, rmse, inl = icp_kernel.icp_step_reference(T, src, pack, t(ref_pose),
                                                     torch.tensor(0.05), intr, W, H,
                                                     float(np.float32(0.0625)))
    np.testing.assert_allclose(T.numpy(), np.asarray(Tj), rtol=0, atol=2e-6)
    assert float(inl) == float(ij) > 5000
    assert abs(float(rmse) - float(rj)) <= 1e-5 * float(rj)


def test_plain_bits_do_not_depend_on_the_thread_count():
    """The plain versions the CPU runs on the tracker's path give the same
    bits on 1 thread and on 4: an ICP iteration, the pose graph, the
    descriptor and the match (no torch reduction decides their order)."""
    T0, cur_v, rw, nw, valid, ref_pose = _level_inputs("translation", 5)
    intr = (K[0], K[1], K[2], K[3])
    args = (t(T0), t(cur_v).reshape(-1, 3), _pack(rw, nw, valid), t(ref_pose),
            torch.tensor(0.05), intr, W, H, float(np.float32(0.0625)))
    rng = np.random.default_rng(2)
    n = 8
    poses = np.stack([np.eye(4, dtype=np.float32)] * n)
    for k in range(n):
        poses[k, :3, 3] = [0.1 * k, 0.003 * k, 0.002 * k * k]
    z = np.stack([np.linalg.inv(poses[k]) @ poses[(k + 1) % n] for k in range(n)])
    z[:, :3, 3] += rng.normal(0, 0.01, (n, 3))
    graph = (t(poses), t(np.arange(n, dtype=np.int32)), t((np.arange(n) + 1) % n),
             t(z.astype(np.float32)), t(np.ones(n, np.float32)))
    depth = t(scene_depth(MOVES["rotation"])[::2, ::2].copy())
    db = torch.from_numpy(rng.normal(0, 1, (16, tlc.DESC_DIM)).astype(np.float32))

    def run():
        desc = tlc.depth_descriptor(depth, depth * 0.3)
        return [*icp_kernel.icp_step_reference(*args), *tlc.optimize_pose_graph(*graph),
                desc, tlc.match_scores(db, desc)]

    prev = torch.get_num_threads()
    try:
        torch.set_num_threads(1)
        one = run()
        torch.set_num_threads(4)
        four = run()
    finally:
        torch.set_num_threads(prev)
    for a, b in zip(one, four):
        assert torch.equal(a, b)


def _fold(prods: np.ndarray) -> np.ndarray:
    """The kernel's sum order written out in numpy float32 scalars: for
    each of the 29 sums, accumulator j takes pixels j, j + 8, ... in order,
    its first row seeding it and a padded pixel (past n, up to a multiple
    of 8) adding +0; then the 8 accumulators added in order 0..7."""
    n = prods.shape[0]
    rows = -(-n // 8)
    out = []
    for c in range(prods.shape[1]):
        part = []
        for j in range(8):
            acc = None
            for i in range(rows):
                x = prods[j + 8 * i, c] if j + 8 * i < n else np.float32(0.0)
                acc = x if acc is None else np.float32(acc + x)
            part.append(acc)
        total = part[0]
        for j in range(1, 8):
            total = np.float32(total + part[j])
        out.append(total)
    return np.array(out, np.float32)


def _fold_case(kind: str, n: int) -> np.ndarray:
    rng = np.random.default_rng(n)
    if kind == "zeros":
        # signed zeros: -0 rows, so that a seed of +0 or a missing +0 of
        # padding shows in the sign bit
        x = np.full((n, icp_kernel.SUMS), -0.0, np.float32)
        x[:, 1::3] = 0.0
        return x
    # magnitudes over 12 decades and both signs: any other order of the
    # adds rounds differently
    mag = 10.0 ** rng.uniform(-6, 6, (n, icp_kernel.SUMS))
    return (mag * rng.choice([-1.0, 1.0], mag.shape)).astype(np.float32)


@pytest.mark.parametrize("kind,n", [("values", 1), ("values", 5), ("values", 8),
                                    ("values", 8 * 3 + 5), ("values", 8 * 40 + 1),
                                    ("values", 1025), ("zeros", 3), ("zeros", 8),
                                    ("zeros", 9), ("zeros", 16)])
def test_sequential_sums_keep_the_kernels_order(kind, n):
    """sequential_sums, the order csrc/icp_step.cu keeps, equals the fold
    written out in float32 scalars bit for bit: n < 8, n = 8k + r and
    signed zeros; on the values, a float64 sum rounded once differs."""
    x = _fold_case(kind, n)
    got = icp_kernel.sequential_sums(torch.from_numpy(x)).numpy()
    want = _fold(x)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    if kind == "values" and n > 8:
        assert not np.array_equal(want, x.astype(np.float64).sum(0).astype(np.float32))


def test_the_cuda_source_holds_the_plain_versions_constants():
    """csrc/icp_step.cu's hex literals are core/exact's doubles (1/n!, 2 pi,
    1/(2 pi)), its damping the float32 1e-6, its accumulators, sums, stage
    rows and stages the plain version's."""
    src = open(SOURCE).read()
    table = re.search(r"kInvFact\[[^\]]*\] = \{([^}]*)\}", src).group(1)
    values = [float.fromhex(v.strip()) for v in table.split(",") if v.strip()]
    assert values == list(exact.INV_FACT)
    consts = dict(re.findall(r"constexpr \w+ (k\w+) = ([^;]+);", src))
    assert float.fromhex(consts["kTwoPi"]) == exact.TWO_PI
    assert float.fromhex(consts["kInvTwoPi"]) == exact.INV_TWO_PI
    assert float(np.float32(consts["kDamping"].rstrip("f"))) == icp_kernel.DAMPING
    assert int(consts["kAcc"]) == icp_kernel.ACC and int(consts["kSums"]) == icp_kernel.SUMS
    assert consts["kStageRows"] == "32 * kPix * kSlotWarps"
    assert 32 * int(consts["kPix"]) * int(consts["kSlotWarps"]) == icp_kernel.STAGE_ROWS
    assert int(consts["kStages"]) == icp_kernel.STAGES
    assert int(consts["kSinTerms"]) == exact.SIN_TERMS


@pytest.mark.parametrize("hw", [(240, 320), (60, 80), (48, 64)])
def test_prep_equals_the_jitted_jax_prep(hw):
    """ROADMAP Queue 3's fault, pinned: on a depth map with isolated valid
    pixels (40% of the pixels dropped at random), ICPOdometry._prep gives
    the jitted JAX _prep's vertices, normals and validity bit for bit at
    every level, at 320x240 and at widths above (80) and below (64) the 72
    where XLA:CPU starts fusing the x rays; the normals at pixels whose
    right and lower neighbours are invalid included."""
    from disinfect_slam_tpu_torch.io.png_io import read_image

    h, w = hw
    rng = np.random.default_rng(h + w)
    depth = read_image(os.path.join(os.path.dirname(__file__), "..", "datasets", "orbit_vga",
                                    "7_depth.png"), unchanged=True).astype(np.float32) / 5000.0
    depth = depth[:: 480 // h, :: 640 // w][:h, :w].copy()
    depth[rng.random(depth.shape) < 0.4] = 0.0
    k = (525.1 * w / 640, 525.3 * h / 480, 319.6 * w / 640, 239.7 * h / 480)
    jpyr = jodo.ICPOdometry(k, h, w)._prep(jnp.asarray(depth))
    tpyr = todo.ICPOdometry(k, h, w, device="cpu")._prep(t(depth))
    lone = 0
    for (vj, nj, okj), (vt, nt, okt) in zip(jpyr, tpyr):
        np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
        np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
        ok = np.asarray(okj)
        lone += int((ok & ~np.roll(ok, -1, 1) & ~np.roll(ok, -1, 0)).sum())
    assert lone > 50


def test_exact_helpers():
    """core/exact: the polynomial sin / cos / atan2 within a few ulps of
    libm's (and the ICP kernel's Python-float sin / cos equal to them),
    tree_sum's halving order, mm's index order and solve_lu against
    numpy's solve."""
    x = torch.linspace(-20.0, 20.0, 4001, dtype=torch.float64)
    s, c = exact.sincos(x)
    assert (s - torch.sin(x)).abs().max() < 4e-16 * 20 and (c - torch.cos(x)).abs().max() < 1e-14
    # the ICP kernel's plain version takes the same polynomial in Python floats
    host = [icp_kernel._sincos(v) for v in x.tolist()]
    assert [h[0] for h in host] == s.tolist() and [h[1] for h in host] == c.tolist()
    y = torch.linspace(-3.0, 3.0, 61, dtype=torch.float64)
    yy, xx = torch.meshgrid(y, y, indexing="ij")
    assert (exact.atan2(yy, xx) - torch.atan2(yy, xx)).abs().max() < 4e-16 * 8
    v = torch.tensor([1.0, 2.0 ** -53, 2.0 ** -53, 3.0, 5.0], dtype=torch.float64)
    assert float(exact.tree_sum(v)) == ((1.0 + 2.0 ** -53) + (2.0 ** -53 + 3.0)) + (5.0 + 0.0)
    a = torch.from_numpy(np.random.default_rng(1).normal(size=(3, 4, 5)))
    b = torch.from_numpy(np.random.default_rng(2).normal(size=(3, 5, 2)))
    np.testing.assert_allclose(exact.mm(a, b).numpy(), (a @ b).numpy(), rtol=0, atol=1e-14)
    m = np.random.default_rng(3).normal(size=(12, 12))
    r = np.random.default_rng(4).normal(size=12)
    np.testing.assert_allclose(exact.solve_lu(torch.from_numpy(m), torch.from_numpy(r)).numpy(),
                               np.linalg.solve(m, r), rtol=0, atol=1e-10)


def test_lockstep_reports_the_first_parting():
    """utils/parting.lockstep over two CPU DenseSLAMs of the same scene:
    no parting; then with the second SLAM's frame-2 depth one float32 ulp
    up, the walk stops at frame 2, the inputs the first stage to part."""
    from disinfect_slam_tpu_torch.systems.dense_slam import DenseSLAM

    from .scenes import checker_rgb

    poses = [look_at((0.01 * i, 0.0, -0.5 + 0.005 * i), (0.0, 0.0, 1.6)) for i in range(4)]
    depths = [scene_depth(p) for p in poses]
    rgb = checker_rgb(W, H)

    def slams():
        return [DenseSLAM(K, H, W, voxel_size=0.02, truncation=0.06, device="cpu",
                          capture=False, loop_closure=True, kf_every=2) for _ in range(2)]

    res = parting.lockstep(slams(), lambda i, slam: slam.process_frame(rgb, depths[i]), 4)
    assert res["parted"] is None and not res["isolated"] and res["frames_run"] == 4
    a, b = slams()

    def feed(i, slam):
        d = depths[i]
        if slam is b and i == 2:
            d = np.where(d > 0, np.nextafter(d, np.float32(np.inf)), d).astype(np.float32)
        slam.process_frame(rgb, d)

    res = parting.lockstep([a, b], feed, 4)
    assert res["parted"]["frame"] == 2 and res["parted"]["stage"] == "inputs"
    assert "parting at frame 2, stage inputs" in parting.describe(res)
