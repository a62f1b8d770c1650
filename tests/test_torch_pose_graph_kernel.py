"""PyTorch port, the pose graph's kernel (ops/cuda/pose_graph_kernel.py) and
the loop closure's captured steps on the CPU: core/exact.solve_lu's
in-place row swap against the LU it replaced, pose_graph_solve_reference
against the inline code it was moved out of, optimize_pose_graph against
golden bits recorded from the code before the kernel (the drifted chain
of tests/test_torch_loop_closure.py and the soak's first closure), the
captured pose graph and query through a stub capturer (keys, replays,
launch accounting), the CUDA source's constants, and a keyframe database
saved by the JAX manager closing loops in the port.  Inputs come from
numpy seeds; every comparison is bit for bit."""

import hashlib
import os
import re

import numpy as np
import pytest
import torch

from disinfect_slam_tpu.systems import loop_closure as jlc
from disinfect_slam_tpu_torch.core import exact
from disinfect_slam_tpu_torch.core.exact import mm
from disinfect_slam_tpu_torch.ops.cuda import pose_graph_kernel as pk
from disinfect_slam_tpu_torch.systems import loop_closure as tlc
from disinfect_slam_tpu_torch.utils import graphs
from disinfect_slam_tpu_torch.utils.graphs import StepGraphs
from disinfect_slam_tpu_torch.utils.kernel_verify import pose_graph_inputs

from .test_torch_graph import StubCapture
from .test_torch_loop_closure import _drifted_chain
from .torch_cases import LC_ARGS, LC_H, LC_K, LC_W, out_and_back_keyframes, pose_graph_case

torch.set_num_threads(1)

_F64 = torch.float64
ROOT = os.path.join(os.path.dirname(__file__), "..")
SOURCE = os.path.join(ROOT, "disinfect_slam_tpu_torch", "csrc", "pose_graph.cu")
SOAK_GRAPH = os.path.join(os.path.dirname(__file__), "data", "soak_first_closure_graph.npz")
JAX_DATABASE = os.path.join(ROOT, "disinfect_slam_tpu_torch", "data", "lc_jax_database.npz")
# sha256 of optimize_pose_graph's poses and costs (float32 bytes) on the drifted
# chain, recorded from the code before pose_graph_solve existed; the soak's
# first closure keeps its recorded outputs in SOAK_GRAPH itself
CHAIN_BITS = "ed30b064adf401b231924140461f7667fb4681873cad0f0f5c39dab352f3fdb9"


# ----------------------------------------------------------------------
# the code before the kernel, kept here as the golden reference
# ----------------------------------------------------------------------
def _solve_lu_before(a, b):
    """core/exact.solve_lu as it was: the row swap gathers all m rows."""
    m = torch.cat([a.to(_F64), b.to(_F64)[:, None]], 1)
    n = a.shape[0]
    rows = torch.arange(n, device=a.device)
    for k in range(n - 1):
        p = k + torch.argmax(torch.abs(m[k:, k]))
        m = m[torch.where(rows == k, p, torch.where(rows == p, k, rows))]
        lo = m[k + 1:, k] / m[k, k]
        m[k + 1:, k + 1:] -= lo[:, None] * m[k, k + 1:]
    rhs = m[:, n]
    x = [None] * n
    for i in range(n - 1, -1, -1):
        x[i] = rhs[i] / m[i, i]
        rhs[:i] -= m[:i, i] * x[i]
    return torch.stack(x)


def _inline_step_before(ja, jb, rd, ei, ej, diag):
    """optimize_pose_graph's inline assembly and solve as they were."""
    n = diag.shape[0] // 6
    e = ei.shape[0]
    ei, ej = ei.long(), ej.long()
    slots = torch.stack([ei * n + ei, ei * n + ej, ej * n + ei, ej * n + ej,
                         n * n + ei, n * n + ej], 1)
    gram = lambda p, q: mm(p.transpose(1, 2), q)  # noqa: E731
    g_pad = torch.zeros((e, 30), dtype=_F64)
    blocks = torch.stack([
        gram(ja, ja).reshape(e, 36), gram(ja, jb).reshape(e, 36),
        gram(jb, ja).reshape(e, 36), gram(jb, jb).reshape(e, 36),
        torch.cat([gram(ja, rd[:, :, None])[:, :, 0], g_pad], 1),
        torch.cat([gram(jb, rd[:, :, None])[:, :, 0], g_pad], 1)], 1)
    acc = torch.zeros((n * n + n, 36), dtype=_F64)
    for k in range(e):
        acc.index_add_(0, slots[k], blocks[k])
    h = acc[:n * n].reshape(n, n, 6, 6).permute(0, 2, 1, 3).reshape(6 * n, 6 * n)
    h = h + torch.diag(diag)
    g = acc[n * n:, :6].reshape(6 * n)
    return (-_solve_lu_before(h, g).to(torch.float32)).reshape(n, 6)


def _swaps(h, g) -> int:
    """Pivot steps of the LU of [h | g] that swap two rows."""
    m = torch.cat([h, g[:, None]], 1)
    swaps = 0
    for k in range(h.shape[0] - 1):
        p = k + int(torch.argmax(torch.abs(m[k:, k])))
        swaps += p != k
        m[[k, p]] = m[[p, k]]
        m[k + 1:, k + 1:] -= (m[k + 1:, k] / m[k, k])[:, None] * m[k, k + 1:]
    return swaps


def _bits(t: torch.Tensor) -> bytes:
    return t.numpy().tobytes()


# ----------------------------------------------------------------------
# solve_lu and the plain version
# ----------------------------------------------------------------------
def _lu_case(kind):
    rng = np.random.default_rng(7)
    if kind == "ties_and_nan":
        a = rng.normal(size=(6, 6))
        a[1, 0], a[2, 0], a[4, 0] = -9.0, 9.0, 9.0  # the first of three largest pivots
        a[3, 2], a[5, 2] = np.nan, np.nan  # a NaN in a later pivot column
        return torch.from_numpy(a), torch.from_numpy(rng.normal(size=6))
    m = int(kind)
    return torch.from_numpy(rng.normal(size=(m, m))), torch.from_numpy(rng.normal(size=m))


@pytest.mark.parametrize("kind", ["6", "48", "192", "ties_and_nan"])
def test_solve_lu_swaps_in_place_with_the_same_bits(kind):
    """The two-row swap on the device gives the bits of the LU that
    gathered every row to swap two (the NaN case: the same NaN bits)."""
    a, b = _lu_case(kind)
    got, want = exact.solve_lu(a, b), _solve_lu_before(a, b)
    assert _bits(got) == _bits(want)
    if kind == "ties_and_nan":
        assert torch.isnan(got).all()
    else:
        assert torch.isfinite(got).all()


@pytest.mark.parametrize("n_pad", [8, 16, 32])
def test_plain_version_equals_the_inline_code_it_left(n_pad):
    """pose_graph_solve_reference (and pose_graph_solve on CPU tensors) on
    random graphs with padded edges gives the inline code's bits, on a
    system whose LU swaps rows."""
    args = pose_graph_inputs(n_pad, 2 * n_pad, seed=n_pad + 1, device="cpu")
    want = _inline_step_before(*args)
    assert _bits(pk.pose_graph_solve_reference(*args)) == _bits(want)
    assert _bits(pk.pose_graph_solve(*args)) == _bits(want)
    assert _swaps(*pk.normal_equations(*args)) > 0
    assert int((args[3] == args[4]).sum()) == n_pad // 2  # the padded edges, 0 -> 0


@pytest.mark.parametrize("case", ["drifted_chain", "soak_first_closure"])
def test_optimize_pose_graph_keeps_the_recorded_bits(case):
    """optimize_pose_graph's poses and costs equal the bits the code before
    the kernel gave, on the drifted chain and on the soak's first closure
    (21 keyframes padded to 32, 21 edges to 32)."""
    if case == "drifted_chain":
        _, est, ei, ej, z, w = _drifted_chain()
        opt, costs = tlc.optimize_pose_graph(*(torch.from_numpy(a) for a in (est, ei, ej, z, w)))
        digest = hashlib.sha256(_bits(opt) + _bits(costs)).hexdigest()
        assert digest == CHAIN_BITS
    else:
        d = np.load(SOAK_GRAPH)
        opt, costs = tlc.optimize_pose_graph(*(torch.from_numpy(d[k])
                                               for k in ("poses", "ei", "ej", "z", "w")))
        assert _bits(opt) == d["opt"].tobytes() and _bits(costs) == d["costs"].tobytes()


# ----------------------------------------------------------------------
# the captured steps through a stub capturer
# ----------------------------------------------------------------------
class RecordingCapture(StubCapture):
    """A stub capturer that runs the body once while it captures, as a CUDA
    capture records the body's launches, and replays by running it again."""

    def __call__(self, body):
        body()
        return super().__call__(body)


def test_captured_pose_graph_keys_replays_and_launches(monkeypatch):
    """PoseGraphStep through the cache: one key per (nodes, edges,
    iterations, damping, device), its outputs the eager function's bits on
    every call, and each replay adding the 12 pose_graph_solve launches its
    capture recorded (a counting stand-in for the kernel)."""
    small, large = pose_graph_case(8, 16, seed=1), pose_graph_case(16, 32, seed=2)
    want = {id(g): tlc.optimize_pose_graph(*(torch.from_numpy(a) for a in g))
            for g in (small, large)}
    real = pk.pose_graph_fused

    # the fused entry's launches count as pose_graph_solve's
    def pose_graph_solve(*args, **kw):
        graphs.count_launch(pose_graph_solve)
        return real(*args, **kw)

    pose_graph_solve.launches = 0
    monkeypatch.setattr(pk, "pose_graph_fused", pose_graph_solve)
    cache = StepGraphs("cpu", capture=RecordingCapture())
    step = tlc.PoseGraphStep("cpu", graphs=cache)
    before = graphs.REPLAYS["pose_graph_solve"]
    for g in (small, small, small, large):
        opt, costs = step(*g)
        assert _bits(opt) == _bits(want[id(g)][0]) and _bits(costs) == _bits(want[id(g)][1])
    assert [k[:6] for k in cache.keys()] == [("pose_graph", 8, 16, 12, 1e-4, "cpu"),
                                             ("pose_graph", 16, 32, 12, 1e-4, "cpu")]
    assert cache.captures == 2 and cache.replays == 2
    # the small graph: 12 eager (its capture's are taken back), then each
    # replay the 12 its capture recorded (and the stub's rerun of the body,
    # another 12: a CUDA replay runs no Python); the large one 12 eager
    assert graphs.REPLAYS["pose_graph_solve"] - before == 24
    assert pose_graph_solve.launches == 12 + 24 + 12 + 24


def test_manager_through_the_cache_equals_the_eager_manager():
    """The out-and-back keyframes through a LoopClosureManager whose query
    and pose graph go through the stub capturer's cache, against one with
    capture=False: the same closures and the same optimized keyframe poses
    bit for bit; the cache holds the query's and the pose graph's keys."""
    _, est, depths = out_and_back_keyframes()
    cache = StepGraphs("cpu", capture=StubCapture())
    cached = tlc.LoopClosureManager(LC_K, LC_H, LC_W, device="cpu", graphs=cache, **LC_ARGS)
    eager = tlc.LoopClosureManager(LC_K, LC_H, LC_W, device="cpu", capture=False, **LC_ARGS)
    for k, (d, e) in enumerate(zip(depths, est)):
        inten = d * 0.3
        for lc in (cached, eager):
            lc.add_keyframe(d, e, frame_id=10 * k, intensity=inten,
                            query=lc.query(d, inten)._replace(scores=None))
    assert cached.closures == eager.closures >= 1
    assert _bits(torch.from_numpy(np.stack(cached.kf_pose_opt))) == _bits(
        torch.from_numpy(np.stack(eager.kf_pose_opt)))
    kinds = {k[0] for k in cache.keys()}
    assert {"lc_query", "pose_graph"} <= kinds and cache.replays > 0


def test_captured_query_equals_the_eager_query():
    """LoopClosureManager.query through the stub capturer's cache: the
    half-res depth, descriptor and scores of the eager query, with and
    without intensity, the database read in place (a keyframe added
    between two queries shows in the second)."""
    _, est, depths = out_and_back_keyframes()
    cache = StepGraphs("cpu", capture=StubCapture())
    cached = tlc.LoopClosureManager(LC_K, LC_H, LC_W, device="cpu", graphs=cache, **LC_ARGS)
    eager = tlc.LoopClosureManager(LC_K, LC_H, LC_W, device="cpu", capture=False, **LC_ARGS)
    for k in range(3):
        for inten in (None, depths[k] * 0.3):
            a, b = cached.query(depths[k], inten), eager.query(depths[k], inten)
            assert all(_bits(x) == _bits(y) for x, y in zip(a, b))
        for lc in (cached, eager):
            lc.add_keyframe(depths[k], est[k], frame_id=10 * k)
    assert float(cached.query(depths[1]).scores[1]) > 0.99
    assert len({k[:3] for k in cache.keys() if k[0] == "lc_query"}) == 2


# ----------------------------------------------------------------------
# the CUDA source and the launch shape
# ----------------------------------------------------------------------
def test_the_cuda_source_holds_the_wrappers_constants():
    """csrc/pose_graph.cu's CTA size, panel width, a thread's panel rows in
    either layout, the register layouts' largest m, the pass layout's
    stride over a panel's rows (a CTA's threads), shared-memory limit, edge entries and edge chunk are the
    wrapper's, its shared-memory sum is smem_bytes', and its
    hex literals are core/exact's doubles (1/n!,
    2 pi, pi / 8's tangent, the float32 1/6 and 1/12)."""
    with open(SOURCE) as f:
        src = f.read()
    consts = dict(re.findall(r"constexpr \w+ (k\w+) = ([^;]+);", src))
    assert int(consts["kThreads"]) == pk.THREADS
    assert int(consts["kNB"]) == pk.NB
    assert int(consts["kMaxSlots"]) == pk.SLOTS and int(consts["kWideSlots"]) == pk.WIDE_SLOTS
    assert int(consts["kMidSlots"]) == pk.MID_SLOTS
    assert consts["kWideRows"] == "kThreads * kWideSlots"
    assert pk.THREADS * pk.WIDE_SLOTS == pk.WIDE_ROWS
    assert src.count("for (int s = t; s < rows; s += kThreads) {") == 3
    assert int(consts["kSmemLimit"]) == pk.SMEM_LIMIT
    assert int(consts["kBlockVals"]) == pk.BLOCK_VALS
    assert int(consts["kEdgeChunk"]) == pk.EDGE_CHUNK
    assert ("return 8 * ((global ? 0 : nlb * kNB * m) + kNB * nlb * kNB + 6 * kNB * kNB + 2 * kNB) +\n"
            "         4 * ((passes ? 8 : 6) * kWarps + 2 * kNB + (passes ? 0 : 2 * static_cast<size_t>(m)) +\n"
            "              3 * kEdgeChunk);") in src
    table = re.search(r"kInvFact\[[^\]]*\] = \{([^}]*)\}", src).group(1)
    assert [float.fromhex(v) for v in table.split(",") if v.strip()] == list(exact.INV_FACT)
    assert float.fromhex(consts["kTwoPi"]) == exact.TWO_PI
    assert float.fromhex(consts["kInvTwoPi"]) == exact.INV_TWO_PI
    assert float.fromhex(consts["kTanPi8"]) == exact.TAN_PI_8
    assert float.fromhex(consts["kPi"]) == np.pi
    assert float.fromhex(consts["kPi2"]) == np.pi / 2 and float.fromhex(consts["kPi4"]) == np.pi / 4
    assert float.fromhex(consts["kSixth"].rstrip("f")) == float(np.float32(1.0 / 6.0))
    assert float.fromhex(consts["kTwelfth"].rstrip("f")) == float(np.float32(1.0 / 12.0))
    assert int(consts["kSinTerms"]) == exact.SIN_TERMS
    assert int(consts["kAtanTerms"]) == exact.ATAN_TERMS


@pytest.mark.parametrize("m, want, shared", [
    (48, 7, True), (96, 13, True), (144, 19, True), (192, 25, True), (384, 49, True),
    (768, 97, True), (1536, 132, True), (1656, 132, False), (3072, 132, False),
    (pk.WIDE_ROWS - 4, 132, False), (pk.WIDE_ROWS + 32, 132, False), (49152, 132, False)])
def test_grid_shape_takes_a_cta_an_sm_and_picks_the_layout(m, want, shared):
    """grid_shape on an H100's 132 SMs: a CTA for every block of columns, up
    to the SMs, the columns in shared memory up to 1536 rows (256 nodes)
    and in device memory above, in the pass layout past WIDE_ROWS (16384
    rows: 16416 and 49152 take it, 16380 does not); every shape listed
    fits; too few SMs to hold the columns take device memory."""
    assert pk.grid_shape(m, 132) == (want, shared)
    passes = m > pk.WIDE_ROWS
    assert pk.launch_layout(m, 132) == (shared, passes)
    assert want in pk.shapes(m, 132, shared)
    assert all(pk.smem_bytes(m, c, shared, passes) <= pk.SMEM_LIMIT
               for c in pk.shapes(m, 132, shared))
    if not shared:
        assert pk.shapes(m, 132, True) == []
    if m == 1536:
        assert pk.grid_shape(m, 64) == (64, False)


def test_the_wrapper_rejects_what_the_kernel_cannot_take():
    args = pose_graph_inputs(8, 16, seed=0, device="cpu")
    bad = [("ja", 0, args[0].float()), ("rd", 2, args[2][:, :5].contiguous()),
           ("ei", 3, args[3].long()), ("diag", 5, args[5][:47].contiguous()),
           ("contiguous", 0, args[0].transpose(1, 2))]
    for name, i, value in bad:
        call = list(args)
        call[i] = value
        with pytest.raises(ValueError):
            pk.pose_graph_solve(*call)


# ----------------------------------------------------------------------
# a keyframe database saved by the JAX manager
# ----------------------------------------------------------------------
def write_jax_database(path: str) -> None:
    """The JAX manager over the first 6 out-and-back keyframes (frame ids
    0-50), saved: disinfect_slam_tpu_torch/data/lc_jax_database.npz."""
    _, est, depths = out_and_back_keyframes()
    lc = jlc.LoopClosureManager(LC_K, LC_H, LC_W, **LC_ARGS)
    for k in range(6):
        lc.add_keyframe(depths[k], est[k], frame_id=10 * k)
    lc.save(path)


def test_the_jax_database_closes_loops_in_the_port(tmp_path):
    """The committed database is what the JAX manager saves now (every key
    equal), and the port loads it and closes a loop at each of the return
    leg's six keyframes (tests/test_torch_gpu.py holds the card to these
    bits)."""
    path = str(tmp_path / "db.npz")
    write_jax_database(path)
    now, committed = np.load(path), np.load(JAX_DATABASE)
    assert sorted(now.files) == sorted(committed.files)
    for key in now.files:
        np.testing.assert_array_equal(now[key], committed[key], err_msg=key)
    _, est, depths = out_and_back_keyframes()
    lc = tlc.LoopClosureManager(LC_K, LC_H, LC_W, device="cpu", **LC_ARGS)
    lc.load(JAX_DATABASE)
    closed = [lc.add_keyframe(depths[k], est[k], frame_id=10 * k) is not None
              for k in range(6, 12)]
    assert closed == [True] * 6 and lc.count == 12
