"""PyTorch port, the raycast kernel's arithmetic on the CPU (the kernel
itself needs the card: tests/test_torch_gpu.py holds it against its plain
version there).

- `Thread` transcribes what one thread of csrc/raycast.cu computes, in
  numpy float32 scalars, with the kernel's early exit, its index (the
  block table read only in a superblock whose occupancy bit is set, any
  negative cell -1) and its last block's lookup reused; on a few hundred
  rays of each golden scene it equals raycast_reference bit for bit (hit,
  depth, rgba, normal): the dense volume with its superblock bits, without
  the skip, with the block skip alone (a window too small for
  superblocks), a camera outside the window, the hash volume, an
  axis-parallel ray (the 1e-9 guards) and a max_depth cut short of the
  surface.  The scalars come from the wrapper's own launch_scalars.
- superblock_bits_reference encodes exactly superblock_table's -3 cells,
  at every cell; its words' bit order and 16-byte padding are pinned, and
  so is where the march reads them (shared or device memory).
- raycast_reference (a DevicePose as well as an SE3) meets the JAX
  raycaster at tests/test_torch_render.py's limits.
- RaycastStep through the stub capturer returns its owner-held images as
  fresh tensors, keyed by where the pose comes from.
- pose_graph_kernel's launch layout and the manager's cap rule past the
  register layouts' 16384 rows, on a stated card."""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from disinfect_slam_tpu.core.geometry import SE3 as JSE3
from disinfect_slam_tpu.ops.raycast import raycast as j_raycast
from disinfect_slam_tpu_torch.config import TSDFConfig
from disinfect_slam_tpu_torch.core.geometry import (SE3, CameraIntrinsics, CameraParams,
                                                    DevicePose, pose_floats)
from disinfect_slam_tpu_torch.ops import raycast as rc
from disinfect_slam_tpu_torch.ops.cuda import pose_graph_kernel as pk
from disinfect_slam_tpu_torch.ops.cuda import raycast_kernel as rk
from disinfect_slam_tpu_torch.systems import loop_closure as lcm
from disinfect_slam_tpu_torch.systems.tsdf_grid import TSDFGrid
from disinfect_slam_tpu_torch.utils import graphs as g

from .scenes import checker_rgb, look_at, render_sphere
from .test_torch_graph import StubCapture
from .test_torch_hash_backend import hash_scene  # noqa: F401  (fixture)
from .test_torch_render import CAM, JCAM, MAX_DEPTH, scenes  # noqa: F401  (fixture)

torch.set_num_threads(1)

F = np.float32
K = (52.7, 53.3, 31.71, 23.43)
W, H = 64, 48
CENTER = (0.013, -0.021, 1.007)
RAYS = 500  # rays of each scene held against the plain version


def _orbit_grid(cfg: TSDFConfig, voxel=0.05, trunc=0.15, frames=4) -> tuple:
    """The golden sphere orbit (tests/test_torch_gpu.py's) fused by the
    port on the CPU: (grid, poses)."""
    grid = TSDFGrid(voxel, trunc, cfg=cfg, device="cpu")
    rng = np.random.default_rng(4)
    poses = []
    for i in range(frames):
        ang = 0.13 * i - 0.12
        pose = look_at((np.sin(ang) * 2.5 + 0.013, 0.1 * i - 0.027, -2.5 * np.cos(ang) + 1.0),
                       CENTER)
        depth = render_sphere(W, H, K, pose, CENTER, 0.613)
        ht, lt = rng.uniform(0.05, 0.95, (2, H, W)).astype(np.float32)
        grid.integrate(checker_rgb(W, H), depth, ht, lt, 4.0, K, pose)
        poses.append(pose)
    return grid, poses


_CAPS = dict(num_blocks_log2=10, max_candidates=2048, max_visible=1024, max_new_per_round=512)


@pytest.fixture(scope="module")
def dense():
    return _orbit_grid(TSDFConfig(grid_log2=6, **_CAPS))


@pytest.fixture(scope="module")
def window8():
    """An 8-block window (two superblocks a side, 3.2 m), the sphere inside."""
    return _orbit_grid(TSDFConfig(grid_log2=3, **_CAPS))


@pytest.fixture(scope="module")
def window4():
    """A 4-block window (too small for superblocks: the block skip alone)
    over x, y in [-0.8, 0.8), z in [0, 1.6) m."""
    return _orbit_grid(TSDFConfig(grid_log2=2, grid_origin=(-2, -2, 0), **_CAPS))


@pytest.fixture(scope="module")
def window8_ahead():
    """An 8-block window from z = 0: the cameras (z < -1 m) outside it, the
    sphere inside."""
    return _orbit_grid(TSDFConfig(grid_log2=3, grid_origin=(-4, -4, 0), **_CAPS))


@pytest.fixture(scope="module")
def hashed():
    return _orbit_grid(TSDFConfig(num_buckets_log2=12, backend="hash", alloc_dedup="sort",
                                  alloc_every=2, **_CAPS), frames=5)


# ----------------------------------------------------------------------
# one kernel thread, transcribed
# ----------------------------------------------------------------------
def _round(x: F) -> int:
    """The kernel's round_to_int: the truncation of x + copysign(0.5, x),
    one float32 add (the plain version's floor(x + 0.5) / ceil(x - 0.5))."""
    return int(np.trunc(np.float32(x) + np.copysign(F(0.5), np.float32(x))))


def _i32(x: int) -> int:
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= 1 << 31 else x


def _norm3(x: F, y: F, z: F) -> F:
    return F(np.sqrt(np.float64((x * x + y * y) + z * z)))


class Thread:
    """csrc/raycast.cu's Params and per-pixel function in numpy float32
    scalars and Python ints (C's int32 arithmetic where it wraps), counting
    the skips it takes, the guards it meets, the lookups it reuses, the
    samples a clear superblock bit answers and its index loads."""

    def __init__(self, vol, cam: CameraParams, pose: SE3, max_depth: float, step_size=None):
        cfg = vol.cfg
        floats, ints = rk.launch_scalars(vol, cam, max_depth, step_size)
        (self.fxi, self.fyi, self.cxi, self.cyi, self.voxel, self.step,
         self.max_step_f) = (F(v) for v in floats)
        (self.max_step, self.refine, _, _, self.bl, self.hash, self.skip, self.super_blocks,
         self.glog2, ox, oy, oz, self.bucket_mask, self.epb_log2, self.entry_mask,
         self.max_probe, self.coord_bits) = list(ints)
        self.org = (ox, oy, oz)
        self.bits = None
        if cfg.backend == "dense":
            table, self.keys = vol.block_table, None
            if self.super_blocks:
                self.bits = rc.superblock_bits_reference(vol).numpy().view(np.uint32)
        else:
            table, self.keys = vol.entry_block, vol.entry_key.numpy()
        self.table = table.numpy()
        self.tsdf, self.rgbw, self.prob = (t.numpy() for t in (vol.tsdf, vol.rgbw, vol.prob))
        slots = pose_floats(pose)[16:]  # world_T_cam's half
        self.t, self.q = slots[9:12], slots[12:16]
        self.last = None
        self.stats = {"block_skips": 0, "super_skips": 0, "guarded": 0, "outside": 0,
                      "reused": 0, "bit_clear": 0, "index_loads": 0}

    def lookup(self, p) -> int:
        """The code of p's block, from the last block's when p lies in it."""
        b = tuple(c >> self.bl for c in p)
        if self.last is not None and self.last[0] == b:
            self.stats["reused"] += 1
            return self.last[1]
        self.last = (b, self.block_code(b))
        return self.last[1]

    def block_code(self, b) -> int:
        if not self.hash:
            gs = 1 << self.glog2
            x, y, z = (b[k] - self.org[k] for k in range(3))
            if not all(0 <= c < gs for c in (x, y, z)):
                self.stats["outside"] += 1
                return -3 if self.super_blocks else -1
            if self.super_blocks:
                sl = self.glog2 - 2
                sb = ((x >> 2) << (2 * sl)) | ((y >> 2) << sl) | (z >> 2)
                if not (int(self.bits[sb >> 5]) >> (sb & 31)) & 1:
                    self.stats["bit_clear"] += 1
                    return -3
            self.stats["index_loads"] += 1
            pool = int(self.table[(x << (2 * self.glog2)) | (y << self.glog2) | z])
            return pool if pool >= 0 else -1
        h = (((b[0] * 73856093) & 0xFFFFFFFF) ^ ((b[1] * 19349669) & 0xFFFFFFFF)
             ^ ((b[2] * 83492791) & 0xFFFFFFFF))
        base = (h & self.bucket_mask) << self.epb_log2
        off, cb = 1 << (self.coord_bits - 1), self.coord_bits
        key = _i32((b[0] + off) | ((b[1] + off) << cb) | ((b[2] + off) << (2 * cb)))
        for k in range(self.max_probe):
            slot = (base + k) & self.entry_mask
            self.stats["index_loads"] += 1
            pool = int(self.table[slot])
            if pool >= 0 and int(self.keys[slot]) == key:
                return pool
        return -1

    def index(self, pool: int, p) -> tuple:
        m = (1 << self.bl) - 1
        return pool, (p[0] & m) + ((p[1] & m) << self.bl) + ((p[2] & m) << (2 * self.bl))

    def read_tsdf(self, p) -> F:
        pool = self.lookup(p)
        return self.tsdf[self.index(pool, p)] if pool >= 0 else F(1.0)

    def skip_steps(self, pos, p, s: int, d) -> int:
        """One division an axis: the finite one of the plain version's jh,
        jl (the other +inf)."""
        span = F(1 << s)
        j = F(np.inf)
        for k in range(3):
            if not abs(d[k]) > F(1e-9):
                self.stats["guarded"] += 1
                continue
            base = F((p[k] >> s) << s)
            bound = ((base + (span - F(0.5))) - F(1e-4) if d[k] > F(1e-9)
                     else (base - F(0.5)) + F(1e-4))
            j = min(j, (bound - pos[k]) / d[k])
        return int(min(max(np.floor(j), F(0.0)), self.max_step_f))

    def __call__(self, u: int, v: int):
        """(hit, depth, rgba, normal) of pixel (u, v)."""
        x = self.fxi * F(u) + self.cxi * F(1.0)
        y = self.fyi * F(v) + self.cyi * F(1.0)
        z = F(1.0)
        n = _norm3(x, y, z)
        vx, vy, vz = x / n, y / n, z / n
        w, ux, uy, uz = self.q
        c = (uy * vz - uz * vy, uz * vx - ux * vz, ux * vy - uy * vx)
        e = (uy * c[2] - uz * c[1], uz * c[0] - ux * c[2], ux * c[1] - uy * c[0])
        dirs = tuple(vv + F(2.0) * (w * cc + ee) for vv, cc, ee in zip((vx, vy, vz), c, e))
        d = tuple(dd * self.step for dd in dirs)
        o = tuple(tt / self.voxel for tt in self.t)
        self.last = None  # a thread's pixel starts with no block
        prev = self.read_tsdf([_round(oo) for oo in o])
        hit, i = False, 1
        while True:
            fi = F(i)
            pos = tuple(o[k] + d[k] * fi for k in range(3))
            p = [_round(pp) for pp in pos]
            pool = self.lookup(p)
            curr = self.tsdf[self.index(pool, p)] if pool >= 0 else F(1.0)
            if prev > 0 and curr <= 0 and prev - curr <= F(1.5):
                lo = [pos[k] - d[k] for k in range(3)]
                hi = list(pos)
                hit = True
                break
            prev = curr
            adv = 1
            if self.skip and pool < 0:
                sup = pool == -3 and self.super_blocks
                self.stats["super_skips" if sup else "block_skips"] += 1
                adv += self.skip_steps(pos, p, self.bl + 2 if sup else self.bl, d)
            i += adv
            if not i < self.max_step:
                break
        if not hit:
            return False, F(0.0), (0, 0, 0, 0), (0, 0, 0, 0)
        mid = [(lo[k] + hi[k]) * F(0.5) for k in range(3)]
        for _ in range(self.refine):
            neg = self.read_tsdf([_round(mm) for mm in mid]) < 0
            for k in range(3):
                if neg:
                    hi[k] = mid[k]
                else:
                    lo[k] = mid[k]
                mid[k] = (lo[k] + hi[k]) * F(0.5)
        f = [_round(mm) for mm in mid]
        pool = self.lookup(f)
        rgb, prob = [F(0.0)] * 3, F(0.0)
        if pool >= 0:
            rw = int(self.rgbw[self.index(pool, f)])
            rgb = [F(rw & 0xFF), F((rw >> 8) & 0xFF), F((rw >> 16) & 0xFF)]
            prob = self.prob[self.index(pool, f)]
        t = lambda a, b, c: self.read_tsdf([f[0] + a, f[1] + b, f[2] + c])  # noqa: E731
        nr = (t(1, 0, 0) - t(-1, 0, 0), t(0, 1, 0) - t(0, -1, 0), t(0, 0, 1) - t(0, 0, -1))
        nrm = _norm3(*nr)
        nrm = F(1.0) if nrm == 0 else nrm
        dot = (nr[0] * -dirs[0] + nr[1] * -dirs[1]) + nr[2] * -dirs[2]
        diffusivity = max(dot / nrm, F(0.0))
        alpha = max(prob - F(0.5), F(0.0)) / F(0.5)
        ng = (F(1.0) - alpha) * (diffusivity * F(255.0))
        u8 = lambda a: int(a) & 0xFF  # noqa: E731
        rgba = (u8(alpha * F(255.0) + (F(1.0) - alpha) * rgb[0]), u8((F(1.0) - alpha) * rgb[1]),
                u8((F(1.0) - alpha) * rgb[2]), 255)
        normal = (u8(alpha * F(255.0) + ng), u8(ng), u8(ng), 255)
        depth = _norm3(*(mid[k] - o[k] for k in range(3))) * self.voxel
        return True, depth, rgba, normal


def _rays(seed: int, extra=()) -> list:
    rng = np.random.default_rng(seed)
    pix = {(int(u), int(v)) for u, v in zip(rng.integers(0, W, RAYS), rng.integers(0, H, RAYS))}
    return sorted(pix | set(extra))


def _hold(vol, cam, pose: SE3, max_depth: float, rays) -> dict:
    """ray_thread against raycast_reference on `rays`; returns the
    thread's counts and the share of rays that hit."""
    ref = rc.raycast_reference(vol, cam, pose, max_depth)
    thread = Thread(vol, cam, pose, max_depth)
    hits = 0
    for u, v in rays:
        hit, depth, rgba, normal = thread(u, v)
        assert hit == bool(ref.hit[v, u]), (u, v)
        assert np.float32(depth).view(np.int32) == ref.depth[v, u:u + 1].numpy().view(np.int32)[0]
        assert rgba == tuple(ref.rgba[v, u].tolist()), (u, v)
        assert normal == tuple(ref.normal[v, u].tolist()), (u, v)
        hits += hit
    return {**thread.stats, "hit_share": hits / len(rays)}


CAM_T = CameraParams.create(CameraIntrinsics.create(*K), H, W)


@pytest.mark.parametrize("case", ["superblocks", "no_skip", "max_depth_cut"])
def test_one_thread_equals_the_plain_version_dense(dense, case):
    grid, poses = dense
    vol = grid.volume
    if case == "no_skip":
        vol = dataclasses.replace(vol, cfg=dataclasses.replace(vol.cfg, raycast_skip=False))
    max_depth = 1.95 if case == "max_depth_cut" else 4.0
    stats = _hold(vol, CAM_T, SE3.from_matrix(poses[1]), max_depth, _rays(1))
    if case == "superblocks":
        assert stats["super_skips"] > 0 and stats["block_skips"] > 0
        assert stats["hit_share"] > 0.1
        # empty superblocks answered from the bits, samples from the last block
        assert stats["bit_clear"] > 0 and stats["reused"] > stats["index_loads"] > 0
    elif case == "no_skip":
        assert stats["super_skips"] == stats["block_skips"] == 0 and stats["hit_share"] > 0.1
    else:
        # the cut (the sphere's near side is ~1.89 m away) ends most rays first
        full = _hold(vol, CAM_T, SE3.from_matrix(poses[1]), 4.0, _rays(1))
        assert 0 < stats["hit_share"] < 0.5 * full["hit_share"]


def test_one_thread_equals_the_plain_version_block_skip_alone(window4):
    grid, poses = window4
    stats = _hold(grid.volume, CAM_T, SE3.from_matrix(poses[0]), 4.0, _rays(2))
    assert not rc.uses_superblocks(grid.cfg) and grid.cfg.raycast_skip
    assert stats["block_skips"] > 0 and stats["super_skips"] == 0 and stats["outside"] > 0
    assert stats["hit_share"] > 0.1


def test_one_thread_equals_the_plain_version_camera_outside_the_window(window8):
    """A camera 4 m before the sphere, outside the 8-block window: rays
    start in the -3 sentinel (outside reads as an empty superblock)."""
    grid, _ = window8
    pose = SE3.from_matrix(look_at((0.4, 0.3, -4.0), CENTER))
    assert rc.uses_superblocks(grid.cfg)
    stats = _hold(grid.volume, CAM_T, pose, 8.0, _rays(3))
    assert stats["outside"] > 0 and stats["super_skips"] > 0 and stats["hit_share"] > 0.02


def test_one_thread_equals_the_plain_version_window_ahead_of_the_camera(window8_ahead):
    """The cameras outside a window that holds the sphere, fused from
    there: rays cross -3 (outside) into superblocks whose bits are set."""
    grid, poses = window8_ahead
    assert rc.uses_superblocks(grid.cfg) and int(grid.volume.block_table.ge(0).sum()) > 0
    stats = _hold(grid.volume, CAM_T, SE3.from_matrix(poses[1]), 4.0, _rays(6))
    assert stats["outside"] > 0 and stats["index_loads"] > 0 and stats["hit_share"] > 0.02


def test_one_thread_equals_the_plain_version_hash(hashed):
    grid, poses = hashed
    stats = _hold(grid.volume, CAM_T, SE3.from_matrix(poses[2]), 4.0, _rays(4))
    assert stats["block_skips"] > 0 and stats["super_skips"] == 0
    assert stats["hit_share"] > 0.1


def test_one_thread_equals_the_plain_version_axis_parallel_rays(dense):
    """The identity rotation and an integer principal point: the centre
    ray is (0, 0, 1) exactly, two of its step's components zero, so the
    skip meets the 1e-9 guards."""
    grid, _ = dense
    cam = CameraParams.create(CameraIntrinsics.create(52.7, 53.3, 32.0, 24.0), H, W)
    # cam_T_world: the camera at (0.013, -0.021, -1.5) looking down +z
    pose = SE3.from_matrix(np.array([[1, 0, 0, -0.013], [0, 1, 0, 0.021], [0, 0, 1, 1.5],
                                     [0, 0, 0, 1]], np.float32))
    thread = Thread(grid.volume, cam, pose, 4.0)
    assert thread.fxi * F(32) + thread.cxi == 0 and thread.fyi * F(24) + thread.cyi == 0
    stats = _hold(grid.volume, cam, pose, 4.0, _rays(5, [(32, 24), (32, 10), (10, 24)]))
    assert stats["guarded"] > 0 and stats["hit_share"] > 0.1


# ----------------------------------------------------------------------
# the superblock bits
# ----------------------------------------------------------------------
def _cell_bits(bits: np.ndarray, glog2: int) -> np.ndarray:
    """Each cell's superblock bit (bool [grid cells]), read as the kernel
    reads it."""
    g = 1 << glog2
    x, y, z = np.meshgrid(*(np.arange(g),) * 3, indexing="ij")
    sl = glog2 - 2
    sb = (((x >> 2) << (2 * sl)) | ((y >> 2) << sl) | (z >> 2)).reshape(-1)
    return ((bits.view(np.uint32)[sb >> 5] >> (sb & 31).astype(np.uint32)) & 1).astype(bool)


@pytest.mark.parametrize("case", ["dense", "window8", "window8_ahead", "window4"])
def test_superblock_bits_encode_the_tables_minus_3_cells(case, request):
    """superblock_bits_reference against superblock_table at every cell: a
    bit is clear exactly where the table holds -3, and the kernel's codes
    (-3 where the bit is clear, else the cell, any negative value -1)
    rebuild the table; a window under 8 blocks a side has no bits."""
    grid, _ = request.getfixturevalue(case)
    vol, cfg = grid.volume, grid.cfg
    bits = rc.superblock_bits_reference(vol)
    assert bits.dtype == torch.int32 and bits.numel() == rc.superblock_words(cfg)
    assert torch.equal(rk.superblock_bits(vol), bits)  # the CPU's wrapper: the plain version
    if case == "window4":
        assert bits.numel() == 0 and not rc.uses_superblocks(cfg) and rk.bits_layout(cfg) is None
        return
    table = rc.superblock_table(vol).numpy()
    held = _cell_bits(bits.numpy(), cfg.grid_log2)
    np.testing.assert_array_equal(table == -3, ~held)
    bt = vol.block_table.numpy()
    np.testing.assert_array_equal(np.where(held, np.where(bt >= 0, bt, -1), -3), table)
    assert held.any() and not held.all()
    assert rk.bits_layout(cfg) == "shared"


def _table_volume(glog2: int, cells) -> SimpleNamespace:
    cfg = TSDFConfig(grid_log2=glog2, num_blocks_log2=6)
    table = torch.full((cfg.grid_cells,), -1, dtype=torch.int32)
    for i, (x, y, z) in enumerate(cells):
        table[(x << 2 * glog2) | (y << glog2) | z] = i
    return SimpleNamespace(cfg=cfg, device=torch.device("cpu"), block_table=table)


def test_superblock_bit_layout_is_pinned():
    """Bit sb & 31 of word sb >> 5, sb = (sx * s + sy) * s + sz; the words
    padded with zeros to a multiple of four; bit 31 makes the int32 word
    negative; allocation's claim codes (-3 - id) count as empty."""
    # 2^3 grid: 8 superblocks, one word and three of padding
    vol = _table_volume(3, [(4, 1, 7)])  # superblock (1, 0, 1): sb 5
    vol.block_table[1] = -3 - 9  # a claim code in superblock 0
    assert rc.superblock_bits_reference(vol).tolist() == [1 << 5, 0, 0, 0]
    # 2^4 grid: 64 superblocks, two words and two of padding
    vol = _table_volume(4, [(0, 0, 0), (15, 15, 15), (8, 0, 4)])  # sb 0, 63, 33
    assert rc.superblock_bits_reference(vol).tolist() == [1, (1 << 1) | -(1 << 31), 0, 0]
    # 2^5 grid: 512 superblocks, 16 words, no padding
    vol = _table_volume(5, [(31, 31, 31), (0, 0, 4 * 7)])  # sb 511, 7
    want = [1 << 7] + [0] * 14 + [-(1 << 31)]
    assert rc.superblock_bits_reference(vol).tolist() == want
    assert rc.superblock_words(vol.cfg) == 16 and rc.superblock_words(TSDFConfig(grid_log2=2)) == 0


def test_the_bits_layout_follows_their_size():
    """Shared memory up to BITS_SMEM_BUDGET (32 KB of bits at grid_log2 8),
    device memory above it (256 KB at 9); either forced within the budget,
    shared refused above it; no bits without superblocks."""
    dense = {g: TSDFConfig(grid_log2=g) for g in (3, 8, 9)}
    assert 4 * rc.superblock_words(dense[8]) == 32768 <= rk.BITS_SMEM_BUDGET
    assert 4 * rc.superblock_words(dense[9]) == 262144 > rk.BITS_SMEM_BUDGET
    assert [rk.bits_layout(dense[g]) for g in (3, 8, 9)] == ["shared", "shared", "device"]
    assert rk.bits_layout(dense[8], "device") == "device"
    with pytest.raises(ValueError, match="shared only up to"):
        rk.bits_layout(dense[9], "shared")
    for cfg in (TSDFConfig(backend="hash"), TSDFConfig(raycast_skip=False),
                TSDFConfig(grid_log2=2)):
        assert rk.bits_layout(cfg) is None
        with pytest.raises(ValueError, match="no superblock bits"):
            rk.bits_layout(cfg, "device")


# ----------------------------------------------------------------------
# the plain version against the JAX raycaster
# ----------------------------------------------------------------------
def _jax_limits(ours, ref):
    """tests/test_torch_render.py's limits: hit and rgba equal, depth
    within 1e-6 relative, normals equal on all but 0.5% of pixels."""
    for f in ("hit", "rgba"):
        np.testing.assert_array_equal(getattr(ours, f).numpy(), np.asarray(getattr(ref, f)))
    np.testing.assert_allclose(ours.depth.numpy(), np.asarray(ref.depth), rtol=1e-6, atol=0)
    assert (ours.normal.numpy() != np.asarray(ref.normal)).any(-1).mean() <= 0.005
    assert ours.hit.float().mean() > 0.5


@pytest.mark.parametrize("skip", [True, False], ids=["skip", "no_skip"])
@pytest.mark.parametrize("pose_kind", ["host", "device"])
def test_plain_version_matches_jax(scenes, skip, pose_kind):  # noqa: F811
    vol_j, vol_t, pose = scenes["normal"]
    vol_j = dataclasses.replace(vol_j, cfg=dataclasses.replace(vol_j.cfg, raycast_skip=skip))
    vol_t = dataclasses.replace(vol_t, cfg=dataclasses.replace(vol_t.cfg, raycast_skip=skip))
    p = SE3.from_matrix(pose)
    p = DevicePose.from_se3(p, "cpu") if pose_kind == "device" else p
    _jax_limits(rc.raycast_reference(vol_t, CAM, p, MAX_DEPTH),
                j_raycast(vol_j, JCAM, JSE3.from_matrix(pose), MAX_DEPTH))


def test_plain_version_matches_jax_on_a_hash_volume(hash_scene):  # noqa: F811
    vol_j, vol_t, pose = hash_scene
    _jax_limits(rc.raycast_reference(vol_t, CAM, DevicePose.from_matrix(pose, "cpu"), 4.0),
                j_raycast(vol_j, JCAM, JSE3.from_matrix(pose), 4.0))


# ----------------------------------------------------------------------
# the captured step
# ----------------------------------------------------------------------
def test_raycast_step_returns_its_owner_held_images(dense):
    """RaycastStep through the stub capturer (a "replay" runs the recorded
    body again): host poses are one key, device poses another; every call
    returns fresh tensors equal to raycast_reference's images, copied from
    the buffers the step holds, whatever the capturer hands back."""
    grid, poses = dense
    stub = StubCapture()
    graphs = g.StepGraphs("cpu", capture=stub)
    step = rk.RaycastStep("cpu", graphs)
    kept = []
    for kind in ("host", "device"):
        for pose in poses[:3]:
            p = SE3.from_matrix(pose)
            res = step(grid.volume, CAM_T, DevicePose.from_se3(p, "cpu") if kind == "device"
                       else p, 4.0)
            ref = rc.raycast_reference(grid.volume, CAM_T, p, 4.0)
            for f in ("hit", "depth", "rgba", "normal"):
                assert torch.equal(getattr(res, f), getattr(ref, f)), (kind, f)
            held = step._outputs[(H, W)]
            assert all(a.data_ptr() != b.data_ptr() for a, b in zip(res, held))
            kept.append(res)
    assert len(stub.bodies) == 2 and graphs.replays == 4
    assert len({r.rgba.data_ptr() for r in kept}) == len(kept)


def test_tsdf_grid_ray_cast_takes_the_step_or_the_eager_kernel(dense):
    """TSDFGrid.ray_cast(renderer="raycast") gives the plain version's
    images with capture on (RaycastStep) and off (one raycast call)."""
    grid, poses = dense
    for capture in (True, False):
        grid.capture = capture
        res = grid.ray_cast(4.0, (K, H, W), poses[0], renderer="raycast")
        ref = rc.raycast_reference(grid.volume, CAM_T, SE3.from_matrix(poses[0]), 4.0)
        for f in ("hit", "depth", "rgba", "normal"):
            assert torch.equal(getattr(res, f), getattr(ref, f)), (capture, f)
    grid.capture = True


# ----------------------------------------------------------------------
# the pose graph past the register layouts
# ----------------------------------------------------------------------
H100 = SimpleNamespace(name="NVIDIA H100 80GB HBM3", total_memory=85_031_714_816,
                       multi_processor_count=132)


@pytest.mark.parametrize("m", [pk.WIDE_ROWS - 4, pk.WIDE_ROWS + 32, 24576, 49152, 98304])
def test_pose_graph_layout_past_the_register_layouts(m):
    """Past WIDE_ROWS the launch takes the pass layout at a CTA an SM; its shared memory holds no per-row array, so
    every m has a shape; the scratch is [H | g] plus about half again."""
    passes = m > pk.WIDE_ROWS
    assert pk.launch_layout(m, 132) == (False, passes)
    assert pk.grid_shape(m, 132) == (132, False)
    fit = pk.shapes(m, 132, False)
    assert fit[-1] == 132 and all(pk.smem_bytes(m, c, False, passes) <= pk.SMEM_LIMIT
                                  for c in fit)
    assert 8 * m * (m + 1) < pk.scratch_bytes(m) < 13 * m * m


def test_the_pass_layout_is_forced_at_any_m_and_checked():
    assert pk.launch_layout(48, 132) == (True, False)
    assert pk.launch_layout(48, 132, passes=True) == (False, True)
    assert pk.launch_layout(3072, 132, shared=False, passes=True) == (False, True)
    assert pk.shapes(48, 132, False, passes=True) == [1, 2, 4, 7]
    with pytest.raises(ValueError, match="passes=True"):
        pk.launch_layout(48, 132, shared=True, passes=True)


def test_the_manager_takes_every_cap_whose_graph_fits(monkeypatch):
    """On an 80 GB card (its properties stated here) the manager's rule
    takes caps up to 8192 keyframes (padded m = 49152: 29.6 GB of scratch)
    and refuses 8193 (16384 nodes: 118 GB) with a message that names the
    cap and the sizes."""
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: H100)
    for cap in (2048, 2049, 4096, 8192):
        lcm.cap_graph_fits(cap, "cuda")
    with pytest.raises(ValueError, match=r"max_keyframes=8193 pads to 16384 nodes.*\[H \| g\]"):
        lcm.cap_graph_fits(8193, "cuda")
