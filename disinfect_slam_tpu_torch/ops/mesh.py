"""Surface mesh of the TSDF volume by marching tetrahedra (counterpart of
disinfect_slam_tpu/ops/mesh.py).

The reference meshes with external tools (KrisLibrary's ExtractMesh in
the ROS path, ros_offline.cc:279-287, and the TSDF2Mesh consumer of the
data.bin dump, README.md:69, 91).  The JAX package extracts the zero
isosurface itself: 6 tetrahedra per cell, 16 sign cases each, vertices
on the zero crossings by linear interpolation, each triangle wound so
that its normal points to the outside (tsdf > 0).

The port keeps its arithmetic op for op (the interpolation, the vertex
and the orientation step), its chunking, its candidate filter and its
clip warning.  It leaves out the TPU's workarounds: the case table and
the 6-way vertex choice are gathers from a table tensor and from the edge
vertices (the JAX package selects them with 16- and 6-way `where`
chains, exact selections, so the bits are the same), and the chunks'
triangles go to the host in one copy of one device `torch.cat` (the JAX
package pads each chunk's slice to a bucket and starts one asynchronous
copy per chunk).
"""

from __future__ import annotations

import contextlib
import logging
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core import voxel as vx
from ..core.state import DEFAULT_TSDF, TSDFVolume
from ..utils.graphs import StepGraphs, keep
from . import hash as h
from .gather import unique_rows
from .integrate import compact_mask

logger = logging.getLogger(__name__)

# the 6 tetrahedra of a unit cell, as corners of the cube (corner c =
# (c & 1, (c >> 1) & 1, (c >> 2) & 1)); they share the main diagonal 0-7,
# so faces agree across neighbouring tetrahedra
_TETS = np.array(
    [[0, 5, 1, 7], [0, 1, 3, 7], [0, 3, 2, 7], [0, 2, 6, 7], [0, 6, 4, 7], [0, 4, 5, 7]],
    np.int32,
)
_CORNER_OFFSETS = np.array(
    [[(c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)], np.int32)
# a tetrahedron's 6 edges as pairs of its local corners 0..3
_TET_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], np.int32)
# the +x, +y, +z neighbours whose boundary voxels close a block's cells
_NEIGHBOURS = ((1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0), (1, 0, 1), (0, 1, 1), (1, 1, 1))


def _build_tet_table() -> np.ndarray:
    """The 16-case table [16, 2, 3] of edge indices (-1: no triangle):
    case bit i set <=> corner i is inside (tsdf < 0); 0, 1 or 2
    triangles a case."""
    eidx = {}
    for k, (a, b) in enumerate(_TET_EDGES):
        eidx[(a, b)] = eidx[(b, a)] = k
    table = -np.ones((16, 2, 3), np.int32)
    for case in range(1, 15):
        inside = [i for i in range(4) if case & (1 << i)]
        outside = [i for i in range(4) if not case & (1 << i)]
        if len(inside) == 1:
            (a,), (b, c, d) = inside, outside
            table[case, 0] = [eidx[(a, b)], eidx[(a, c)], eidx[(a, d)]]
        elif len(inside) == 3:
            (a,), (b, c, d) = outside, inside
            table[case, 0] = [eidx[(a, b)], eidx[(a, d)], eidx[(a, c)]]
        else:
            (a, b), (c, d) = inside, outside
            q = [eidx[(a, c)], eidx[(a, d)], eidx[(b, d)], eidx[(b, c)]]
            table[case, 0] = [q[0], q[1], q[2]]
            table[case, 1] = [q[0], q[2], q[3]]
    return table


_TET_TABLE = _build_tet_table()
# the tables above as device tensors, made once a device (a capture may
# not copy from the host): {device: {name: tensor}}, and the corner
# offsets in metres a (device, voxel size)
_DEVICE_TABLES: dict = {}


def _tables(dev: torch.device, voxel_size: float) -> dict:
    """The neighbour offsets i32 [7, 3], the case table, the tetrahedron
    edges' corners, a triangle's vertex order flipped, and the corner
    offsets f32 [8, 3] in metres (each Python product rounded once to
    float32) on `dev`."""
    key = str(dev)
    t = _DEVICE_TABLES.get(key)
    if t is None:
        t = {"neighbours": torch.from_numpy(np.asarray(_NEIGHBOURS, np.int32)).to(dev),
             "table": torch.from_numpy(_TET_TABLE).to(dev),
             "ea": torch.from_numpy(_TET_EDGES[:, 0]).long().to(dev),
             "eb": torch.from_numpy(_TET_EDGES[:, 1]).long().to(dev),
             "flipped": torch.tensor([0, 2, 1], dtype=torch.long, device=dev)}
        _DEVICE_TABLES[key] = t
    ck = ("corner_offsets", float(voxel_size))
    if ck not in t:
        t[ck] = torch.from_numpy(
            (_CORNER_OFFSETS.astype(np.float64) * voxel_size).astype(np.float32)).to(dev)
    return {**t, "corner_offsets": t[ck]}


class Mesh(NamedTuple):
    vertices: torch.Tensor  # f32 [max_tris, 3, 3] world metres
    valid: torch.Tensor  # bool [max_tris]
    count: torch.Tensor  # i32 []


def extract_mesh(vol: TSDFVolume, max_tris: int = 1 << 18) -> Mesh:
    """Triangle soup of the zero isosurface over all live blocks (up to
    max_visible of them), in one pass.  Cells with an unobserved corner
    (weight 0 and tsdf at its initial value, or no block) emit nothing."""
    vis = compact_mask(vol, vol.entry_block >= 0)
    return _extract_from_blocks(vol, vis.block_pos, vis.pool_idx, vis.mask, max_tris)


def compact_mesh(mesh: Mesh) -> np.ndarray:
    """[count, 3, 3] float32 triangles on the host; only the real rows are
    copied."""
    return mesh.vertices[:int(mesh.count)].cpu().numpy()


def _candidates(vol: TSDFVolume) -> torch.Tensor:
    """Live entries whose block can emit a triangle: the tsdf range over
    the block and its 7 +neighbours spans 0 (fmax >= 0, not > 0, as the
    cells' predicate, so that a field whose max is exactly 0 still
    emits).  Per-row minima and maxima are taken once and gathered, which
    equals the JAX package's min over each gathered neighbour row."""
    cfg = vol.cfg
    live = vol.entry_block >= 0
    row_min, row_max = vol.tsdf.amin(dim=1), vol.tsdf.amax(dim=1)
    pool = vol.entry_block.clamp(0, cfg.num_blocks - 1).long()
    fmin = torch.where(live, row_min[pool], torch.inf)
    fmax = torch.where(live, row_max[pool], -torch.inf)
    pos = vol.entry_pos
    offsets = _tables(vol.device, cfg.voxel_size)["neighbours"]
    for k in range(len(_NEIGHBOURS)):
        npool = h.lookup(vol, pos + offsets[k])
        nhit = (npool >= 0) & live
        nrow = npool.clamp(0, cfg.num_blocks - 1).long()
        fmin = torch.where(nhit, torch.minimum(fmin, row_min[nrow]), fmin)
        fmax = torch.where(nhit, torch.maximum(fmax, row_max[nrow]), fmax)
    return live & (fmin < 0) & (fmax >= 0)


class MeshGraphs:
    """extract_mesh_chunked's captured steps on one device (utils/graphs.py):
    the candidate pass, keyed by the volume's storage_key(), and the chunk
    body (_extract_from_blocks, then the q16 quantization), keyed by the
    storage, the chunk size, the triangle cap and the transfer, reading its
    chunk from static inputs that every chunk body of this object shares.
    A call makes its own by default, freed when it returns: pass one to
    let repeated calls on the same volume replay every step."""

    def __init__(self, device, graphs: Optional[StepGraphs] = None):
        self.device = torch.device(device)
        self.graphs = graphs if graphs is not None else StepGraphs(self.device)
        self._inputs = {}
        # the steps' outputs, shared like the inputs: {(step, sizes): buffers}
        self.outputs = {}

    def inputs(self, chunk: int) -> dict:
        """The chunk body's static inputs for `chunk` rows: block_pos i32
        [chunk, 3], pool_idx i32 [chunk], mask bool [chunk], and the q16
        frame's origin f32 [3] and step f32 []."""
        if chunk not in self._inputs:
            dev = self.device
            self._inputs[chunk] = {
                "block_pos": torch.zeros((chunk, 3), dtype=torch.int32, device=dev),
                "pool_idx": torch.zeros((chunk,), dtype=torch.int32, device=dev),
                "mask": torch.zeros((chunk,), dtype=torch.bool, device=dev),
                "q_origin": torch.zeros((3,), dtype=torch.float32, device=dev),
                "q_step": torch.ones((), dtype=torch.float32, device=dev)}
        return self._inputs[chunk]


def _chunk_body(vol, block_pos, pool_idx, mask, max_tris, q_origin=None, q_step=None):
    """One chunk's triangles (f32 [max_tris, 3, 3], or with a q16 frame
    i16 [max_tris, 3, 3] holding value - 32768) and its count."""
    mesh = _extract_from_blocks(vol, block_pos, pool_idx, mask, max_tris)
    verts = mesh.vertices
    if q_origin is not None:
        q = torch.round((verts - q_origin) / q_step).clamp(0, 65535)
        # 16 bits as int16 (value - 32768): torch's uint16 lacks ops
        verts = (q - 32768.0).to(torch.int16)
    return verts, mesh.count


def extract_mesh_chunked(
    vol: TSDFVolume,
    max_tris_per_chunk: int = 1 << 18,
    chunk: int = 512,
    transfer: str = "f32",
    bucket: int = 4096,
    capture: bool = True,
    graphs: Optional[MeshGraphs] = None,
) -> np.ndarray:
    """Memory-bounded extraction -> [N, 3, 3] float32 triangles on the
    host.  The candidate blocks (_candidates) go through
    _extract_from_blocks `chunk` at a time, the last chunk padded as the
    JAX package pads it (pool index num_blocks, mask False: the padded rows
    emit nothing), at most max_tris_per_chunk triangles a chunk; a chunk
    that reaches the cap is clipped and counted, with one warning for the
    call.  Each chunk's triangles and count are copied into one buffer of
    [chunks, max_tris_per_chunk, 3, 3] (sized from the chunk count: 9.4 MB
    a chunk in f32 at the default cap) before the next chunk runs; then one
    read of the counts and one copy of the triangles to the host.

    On a CUDA device the candidate pass and each chunk are captured steps
    (MeshGraphs; the first chunk of a key runs eagerly, the rest replay),
    each chunk read from the static inputs; torch.nonzero over the
    candidates stays outside them, the one read that sizes the loop, as
    the JAX package's np.asarray of its jitted candidates.  capture=False
    runs the same steps eagerly.

    transfer="q16" quantizes the vertices on the device to 16-bit fixed
    point in steps of voxel/16 from the candidate blocks' low corner (at
    most 1/32 voxel of error, half the bytes to copy), and dequantizes
    them on the host; it falls back to float32 when the extent exceeds
    65534 steps.  A q16 mesh welds slivers thinner than a step in
    merge_vertices.  `bucket` (the JAX package's transfer padding) is
    accepted and ignored."""
    del bucket
    cfg = vol.cfg
    dev = vol.device
    graphs = graphs if graphs is not None else MeshGraphs(dev)
    run = graphs.graphs.run if capture else (lambda _key, body: body())
    storage = vol.storage_key()
    run(("mesh_candidates",) + storage,
        lambda: keep(graphs.outputs, ("candidates", cfg.num_entries), _candidates(vol)))
    idx = torch.nonzero(graphs.outputs[("candidates", cfg.num_entries)][0]).flatten()
    n = idx.numel()
    if n == 0:
        return np.zeros((0, 3, 3), np.float32)
    block_pos = vol.entry_pos[idx]
    pool_idx = vol.entry_block[idx]

    q_origin = q_step = None
    if transfer == "q16":
        bp = block_pos.cpu().numpy()
        bl = cfg.block_len
        lo = bp.min(axis=0).astype(np.float64) * bl * cfg.voxel_size
        hi = (bp.max(axis=0).astype(np.float64) + 1) * bl * cfg.voxel_size
        step = cfg.voxel_size / 16.0
        if float((hi - lo).max()) / step < 65534.0:
            q_origin, q_step = lo.astype(np.float32), np.float32(step)
    quant = q_origin is not None

    n_chunks = -(-n // chunk)
    pad = n_chunks * chunk - n
    bp_all = torch.cat([block_pos, block_pos.new_zeros((pad, 3))])
    pi_all = torch.cat([pool_idx, pool_idx.new_full((pad,), cfg.num_blocks)])
    m_all = torch.arange(n_chunks * chunk, device=dev) < n
    static = graphs.inputs(chunk)
    rows = (static["block_pos"], static["pool_idx"], static["mask"])
    frame = ()
    if quant:
        # device tensors: torch on CUDA divides by a Python scalar through
        # its reciprocal
        static["q_origin"].copy_(torch.from_numpy(q_origin))
        static["q_step"].fill_(float(q_step))
        frame = (static["q_origin"], static["q_step"])
    sizes = (chunk, max_tris_per_chunk, "q16" if quant else "f32")
    verts_all = torch.empty((n_chunks, max_tris_per_chunk, 3, 3),
                            dtype=torch.int16 if quant else torch.float32, device=dev)
    counts_all = torch.empty((n_chunks,), dtype=torch.int32, device=dev)
    for i in range(n_chunks):
        sel = slice(i * chunk, (i + 1) * chunk)
        for dst, src in zip(rows, (bp_all[sel], pi_all[sel], m_all[sel])):
            dst.copy_(src)
        run(("mesh_chunk",) + sizes + storage, lambda: keep(
            graphs.outputs, sizes, *_chunk_body(vol, *rows, max_tris_per_chunk, *frame)))
        verts, count = graphs.outputs[sizes]
        verts_all[i].copy_(verts)
        counts_all[i].copy_(count)

    counts = counts_all.cpu().numpy()  # one read
    clipped = int(np.sum(counts >= max_tris_per_chunk))
    out = torch.cat([verts_all[i, :int(min(c, max_tris_per_chunk))]
                     for i, c in enumerate(counts)])
    tris = out.cpu().numpy()  # one copy
    if quant:
        tris = q_origin + (tris.astype(np.int32) + 32768).astype(np.float32) * q_step
    if clipped:
        logger.warning(
            "mesh extraction clipped %d/%d chunks at %d tris; "
            "lower `chunk` or raise `max_tris_per_chunk` for the full mesh",
            clipped, n_chunks, max_tris_per_chunk)
    return tris


def _block_fields(vol: TSDFVolume, block_pos, pool_idx, mask):
    """Each block's (bl+1)^3 tsdf field and observed mask [V, z, y, x]:
    its own row and the boundary slabs of its 7 +neighbours.  A missing
    neighbour reads the default voxel (tsdf +1, weight 0: unobserved), as
    Retrieve does on a miss (voxel_hash.cuh:104-112)."""
    cfg = vol.cfg
    bl = cfg.block_len
    vcap = block_pos.shape[0]
    s = bl + 1

    def rows_of(pool, hit):
        p = pool.clamp(0, cfg.num_blocks - 1).long()
        t = torch.where(hit[:, None], vol.tsdf[p], DEFAULT_TSDF)
        w = torch.where(hit[:, None], ((vol.rgbw[p] >> 24) & 0xFF).float(), 0.0)
        return t.reshape(vcap, bl, bl, bl), w.reshape(vcap, bl, bl, bl)

    own_hit = mask & (pool_idx >= 0) & (pool_idx < cfg.num_blocks)
    t_own, w_own = rows_of(pool_idx, own_hit)
    tf = torch.full((vcap, s, s, s), DEFAULT_TSDF, dtype=torch.float32, device=vol.device)
    wf = torch.zeros((vcap, s, s, s), dtype=torch.float32, device=vol.device)
    tf[:, :bl, :bl, :bl] = t_own
    wf[:, :bl, :bl, :bl] = w_own
    offsets = _tables(vol.device, cfg.voxel_size)["neighbours"]
    for k, d in enumerate(_NEIGHBOURS):
        npool = h.lookup(vol, block_pos + offsets[k])
        t_n, w_n = rows_of(npool, mask & (npool >= 0))
        dx, dy, dz = d
        # the neighbour's 0-plane along each offset axis goes to the
        # field's index bl along that axis
        src = tuple(slice(0, 1) if o else slice(0, bl) for o in (dz, dy, dx))
        dst = tuple(slice(bl, s) if o else slice(0, bl) for o in (dz, dy, dx))
        tf[(slice(None),) + dst] = t_n[(slice(None),) + src]
        wf[(slice(None),) + dst] = w_n[(slice(None),) + src]
    # observed: fused data, weight > 0 or tsdf moved off its reset/default
    # value (far-depth fusion rounds the weight to 0 while it still writes
    # tsdf, voxel_tsdf.cu:182, 192)
    return tf, (wf > 0) | (tf.abs() < 0.999)


def _sum3(a, b, c):
    return (a + b) + c


def _extract_from_blocks(vol: TSDFVolume, block_pos: torch.Tensor, pool_idx: torch.Tensor,
                         mask: torch.Tensor, max_tris: int) -> Mesh:
    """Marching tetrahedra over the cells of blocks [V] (block_pos [V, 3],
    pool_idx [V], mask [V]) -> at most max_tris triangles, in the JAX
    package's order (tetrahedron, then triangle slot, then cell)."""
    cfg = vol.cfg
    dev = vol.device
    vcap = block_pos.shape[0]
    bl = cfg.block_len
    bv = bl ** 3
    tf, obs = _block_fields(vol, block_pos, pool_idx, mask)

    # the corners' slabs, flattened to the in-block cell order x + 8y + 64z
    f8, o8 = [], []
    for dx, dy, dz in _CORNER_OFFSETS:
        f8.append(tf[:, dz:dz + bl, dy:dy + bl, dx:dx + bl].reshape(-1))
        o8.append(obs[:, dz:dz + bl, dy:dy + bl, dx:dx + bl].reshape(-1))
    vcount = vcap * bv
    fv_all = torch.stack(f8, dim=1)  # [N, 8]
    okv_all = mask.repeat_interleave(bv) & torch.stack(o8, dim=1).all(dim=1)

    # only cells with mixed corner signs emit; they are compacted into
    # cell_cap slots (a producing cell emits 2 triangles on average), the
    # rest dropping as the triangle cap drops; slot cell_cap is scratch
    cell_cap = max(256, max_tris // 2)
    cand = okv_all & (fv_all.amin(dim=1) < 0) & (fv_all.amax(dim=1) >= 0)
    cids, okv, _ = _compact(cand, torch.arange(vcount, dtype=torch.int32, device=dev),
                            cell_cap, vcount)
    cids_safe = cids.clamp(0, vcount - 1)
    fv = fv_all[cids_safe.long()]  # [C, 8]

    # the cells' corner positions: block base + cell offset + corner
    base = vx.block_to_point(block_pos, cfg)
    blk_of = (cids_safe >> (3 * cfg.block_len_log2)).long()
    coffc = vx.index_to_offset(cids_safe & (bv - 1), cfg)
    vsz = cfg.voxel_size
    tables = _tables(dev, vsz)
    cell0 = (base[blk_of] + coffc).float() * vsz
    corner_pos = [cell0 + tables["corner_offsets"][c] for c in range(8)]  # 8 x [C, 3]

    table = tables["table"]  # [16, 2, 3]
    ea, eb = tables["ea"], tables["eb"]
    tri_vs, tri_valid = [], []
    for tet in _TETS:
        ft = torch.stack([fv[:, int(c)] for c in tet], dim=1)  # [C, 4]
        pt = torch.stack([corner_pos[int(c)] for c in tet], dim=1)  # [C, 4, 3]
        neg_b = ft < 0
        case = (neg_b[:, 0].int() | (neg_b[:, 1].int() << 1) | (neg_b[:, 2].int() << 2)
                | (neg_b[:, 3].int() << 3)).long()
        # the crossing on each of the 6 edges
        fa, fb = ft[:, ea], ft[:, eb]
        pa, pb = pt[:, ea], pt[:, eb]
        denom = fa - fb
        alpha = torch.where(denom.abs() > 1e-12,
                            fa / torch.where(denom == 0, 1.0, denom), 0.5)
        alpha = alpha.clamp(0.0, 1.0)
        everts = pa + alpha[..., None] * (pb - pa)  # [C, 6, 3]

        # outward: from the centroid of the inside corners to that of the
        # outside ones; it orients each triangle (the cube's 6 tetrahedra
        # have mixed parity), sums taken corner by corner in order
        neg = neg_b.float()
        pos = 1.0 - neg
        n_neg = torch.clamp(((neg[:, 0] + neg[:, 1]) + neg[:, 2]) + neg[:, 3], min=1.0)
        n_pos = torch.clamp(((pos[:, 0] + pos[:, 1]) + pos[:, 2]) + pos[:, 3], min=1.0)
        wn, wp = pt * neg[..., None], pt * pos[..., None]
        cent_neg = (((wn[:, 0] + wn[:, 1]) + wn[:, 2]) + wn[:, 3]) / n_neg[:, None]
        cent_pos = (((wp[:, 0] + wp[:, 1]) + wp[:, 2]) + wp[:, 3]) / n_pos[:, None]
        outward = cent_pos - cent_neg  # [C, 3]

        tri_edges = table[case]  # [C, 2, 3]
        for k in range(2):
            tk = tri_edges[:, k]  # [C, 3]
            valid = okv & (tk[:, 0] >= 0)
            # an exact selection of the edge vertices (-1 rows are invalid)
            sel = tk.clamp(min=0).long()[..., None].expand(-1, 3, 3)
            v3 = everts.gather(1, sel)  # [C, 3, 3]
            e1, e2 = v3[:, 1] - v3[:, 0], v3[:, 2] - v3[:, 0]
            nrm = torch.stack([e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
                               e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
                               e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]], dim=1)
            prod = nrm * outward
            flip = _sum3(prod[:, 0], prod[:, 1], prod[:, 2]) < 0
            v3 = torch.where(flip[:, None, None], v3.index_select(1, tables["flipped"]), v3)
            tri_vs.append(v3)
            tri_valid.append(valid)

    all_tris = torch.cat(tri_vs, dim=0)  # [12 C, 3, 3]
    all_valid = torch.cat(tri_valid, dim=0)
    out, valid, total = _compact(all_valid, all_tris, max_tris, 0.0)
    return Mesh(vertices=out, valid=valid, count=torch.clamp(total, max=max_tris))


def _compact(mask: torch.Tensor, rows: torch.Tensor, cap: int, fill):
    """The rows where mask, in order, in `cap` slots, the rest `fill`
    (the JAX package's cumsum rank and drop-scatter; slot cap is a scratch
    slot for every other row) -> (rows [cap, ...], kept [cap], count of
    True 0-d i32)."""
    rank = h.cumsum_i32(mask) - 1
    slot = torch.where(mask & (rank < cap), rank, cap).long()
    buf = torch.full((cap + 1,) + tuple(rows.shape[1:]), fill, dtype=rows.dtype,
                     device=rows.device)
    buf[slot] = rows
    total = mask.sum(dtype=torch.int32)
    return buf[:cap], torch.arange(cap, device=mask.device) < total, total


def merge_vertices(tris: np.ndarray, tol: float = 1e-5):
    """Triangle soup -> indexed mesh (vertices, faces) by welding
    coincident vertices (MergeVertices(mesh, eps), ros_interface.cpp:103);
    on the host, as in the JAX package, with its results: the rows of its
    np.unique(axis=0) from gather.unique_rows, and its np.add.at sums
    from np.bincount, which adds the same float64 terms in the same
    order."""
    flat = tris.reshape(-1, 3)
    key = np.round(flat / tol).astype(np.int64)
    uniq, inv = unique_rows(key)
    n = len(uniq)
    counts = np.bincount(inv, minlength=n)
    verts = np.stack([np.bincount(inv, weights=flat[:, k].astype(np.float64), minlength=n)
                      for k in range(3)], axis=1)
    verts /= np.maximum(counts[:, None], 1)
    faces = inv.reshape(-1, 3)
    good = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
            & (faces[:, 0] != faces[:, 2]))
    return verts.astype(np.float32), faces[good]


def _point_summary(points: np.ndarray) -> dict:
    flat = points.reshape(-1, 3).astype(np.float64)
    empty = flat.shape[0] == 0
    return {"vertex_sum": flat.sum(axis=0).tolist(),
            "bbox_min": [0.0] * 3 if empty else flat.min(axis=0).tolist(),
            "bbox_max": [0.0] * 3 if empty else flat.max(axis=0).tolist()}


def mesh_fingerprint(tris: np.ndarray, clipped: int) -> dict:
    """Summary of a triangle soup for comparing two implementations at
    scale: triangle count, clipped chunks, float64 per-axis sums of the
    triangles' vertices, their bounding box, and merge_vertices' vertex
    and face counts."""
    verts, faces = merge_vertices(tris)
    return {"triangles": int(tris.shape[0]), "clipped_chunks": int(clipped),
            **_point_summary(tris), "merged_vertices": int(len(verts)),
            "merged_faces": int(len(faces))}


def indexed_mesh_fingerprint(verts: np.ndarray, faces: np.ndarray) -> dict:
    """The same summary of an indexed mesh (merge_vertices' output)."""
    return {"merged_vertices": int(len(verts)), "merged_faces": int(len(faces)),
            **_point_summary(verts)}


@contextlib.contextmanager
def counting_clips(name: str = __name__):
    """Counts the chunks that extract_mesh_chunked clips while the block
    runs, from its warning on the logger `name` (this module's, or the JAX
    package's) -> a one-item list holding the count."""
    counted = [0]

    class _Handler(logging.Handler):
        def emit(self, record):
            if record.getMessage().startswith("mesh extraction clipped"):
                counted[0] += int(record.args[0])

    log = logging.getLogger(name)
    handler = _Handler(logging.WARNING)
    log.addHandler(handler)
    try:
        yield counted
    finally:
        log.removeHandler(handler)


def vertex_attributes(vol: TSDFVolume, verts: np.ndarray):
    """(rgb u8 [N, 3], ht probability f32 [N]) sampled at the voxels of
    mesh vertices (rounded on the host, read on the volume's device)."""
    pts = np.round(verts / vol.cfg.voxel_size).astype(np.int32)
    _, rgb, _, prob = h.read_voxels(vol, torch.from_numpy(pts).to(vol.device))
    return (np.clip(rgb.cpu().numpy(), 0, 255).astype(np.uint8),
            prob.cpu().numpy().astype(np.float32))


def save_ply(path: str, verts: np.ndarray, faces: np.ndarray,
             rgb: np.ndarray | None = None, prob: np.ndarray | None = None) -> None:
    """Write a binary PLY mesh, optionally with per-vertex colour and the
    high-touch probability as a custom scalar (the semantic mesh output
    the reference's geometry-only pipeline cannot produce).  The vertex
    and face records are packed structured arrays written at once, the
    bytes of the JAX package's record-by-record writer."""
    head = ["ply", "format binary_little_endian 1.0", f"element vertex {len(verts)}",
            "property float x", "property float y", "property float z"]
    fields = [("xyz", "<f4", (3,))]
    if rgb is not None:
        head += ["property uchar red", "property uchar green", "property uchar blue"]
        fields.append(("rgb", "u1", (3,)))
    if prob is not None:
        head += ["property float ht_probability"]
        fields.append(("p", "<f4"))
    head += [f"element face {len(faces)}", "property list uchar int vertex_indices",
             "end_header"]
    vrec = np.zeros(len(verts), np.dtype(fields))
    vrec["xyz"] = verts
    if rgb is not None:
        vrec["rgb"] = rgb
    if prob is not None:
        vrec["p"] = prob
    frec = np.zeros(len(faces), np.dtype([("n", "u1"), ("idx", "<i4", (3,))]))
    frec["n"] = 3
    frec["idx"] = faces
    with open(path, "wb") as fp:
        fp.write(("\n".join(head) + "\n").encode())
        fp.write(vrec.tobytes())
        fp.write(frec.tobytes())


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    """Write a Wavefront OBJ (the portable stand-in for the reference's
    shape_msgs/Mesh publication): the JAX package's lines ("v %.6f %.6f
    %.6f", "f %d %d %d", 1-based), 2^16 lines formatted by one string
    operation rather than one a line."""
    rows = 1 << 16
    with open(path, "w") as fp:
        for fmt, arr in (("v %.6f %.6f %.6f\n", verts), ("f %d %d %d\n", faces + 1)):
            for s0 in range(0, len(arr), rows):
                block = arr[s0:s0 + rows]
                fp.write((fmt * len(block)) % tuple(block.ravel().tolist()))
