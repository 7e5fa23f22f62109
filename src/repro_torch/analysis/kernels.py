"""Kernel-site lint: K001–K005 over the launches a forward makes.

The port's counterpart of ``repro.analysis.kernels``.  The JAX package
reads each ``pallas_call``'s grid and index maps out of a jaxpr; a CUDA
kernel has no such record, so a *site* here is one kernel call that a
target's forward resolved (``repro_torch.kernels.plans.capture``: the
kernel, its dims and the plan the wrapper resolved), and its launch is
derived from the kernels' own formulas (``kernels/tiling.py`` for the
two FC kernels, the copies below for the three entry kernels): the grid,
which output tiles each block writes, the operands kept resident in
shared memory, the route's preconditions and the shared memory a block
takes.  Nothing here launches a kernel.  The plans use the card's SM
count for a call that ran on the card and ``repro_torch.HW``'s H100
count otherwise; on the card each built library also answers for its
own launch, so the copies are held to the sources they copy.

* **K001** — a block's shared memory by the formulas must fit the
  kernel's limit (227 KB, less the static part where a kernel has one);
  on the card it must also equal the built library's own count
  (``gather_mlp_smem_bytes``, ``hub_reuse_smem_bytes``,
  ``knn_smem_bytes``, ``flash_attention_layout``, ``ssd_chunk_plan``).
* **K002** — each route's alignment precondition: the narrow row tile
  holds whole 16-padded subsets, the linear one whole subsets packed K
  rows apart, the wide route's F tiles are 64-column multiples of at
  most 256, ``wgmma`` takes bf16 rows of 16 bytes, a
  chunk is 64 or 128 cache rows, an SSD chunk at most 128 rows on its
  ``whole`` route, a flash head at most 256 wide off its split routes,
  and on the ``split`` route D within its cluster's slices (at most 8
  blocks a cluster).
* **K003** — the grid writes every output tile and no block writes
  only outside the output or nothing, the splits of H and of the cache
  rows and the linear route's row tiles of a long subset cover them, and the plan that launched (captured on the card, or
  reported there by the library: ``gather_mlp_wide_plan``, ``knn_plan``,
  ``flash_attention_layout``'s tiles, ``ssd_chunk_plan``) equals the
  derived one.
* **K004** — an operand the plan keeps resident in shared memory (the
  wide route's x tile where ``resident``, the narrow route's row tile of
  x and h, hub_reuse's slot table) covers its array.
* **K005** — no output tile is written by two blocks unless they differ
  only along an axis the plan merges in order (the wide route's
  ``nsplit`` second pass, ``hub_reuse``'s max over chunks): the kernels'
  no-atomics contract.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import Callable

from .. import HW
from ..kernels import tiling
from ..kernels.tiling import MAX_SMEM, SMEM_SM, round_up
from .findings import Finding

#: a kernel's static shared memory is set aside from a block's limit
STATIC_SMEM = 1024
#: grids past this many blocks are probed at their corners only
MAX_PROBE = 1 << 17
MERGE, PARALLEL = "merge", "parallel"


@dataclass
class OperandInfo:
    """An operand (or a tile of one) a block keeps in shared memory."""
    name: str
    array_shape: tuple
    block_shape: tuple
    resident: bool


@dataclass
class KernelSite:
    """One kernel call, its launch derived from the kernels' formulas."""
    kernel: str
    where: str
    dims: dict
    plan: dict                       # the plan the wrapper resolved
    grid: tuple                      # blocks along each launch axis
    semantics: tuple                 # PARALLEL or MERGE per grid axis
    out_shape: tuple                 # the output, in tiles of out_block
    out_block: tuple
    out_map: Callable                # grid point -> the tiles it writes
    smem: int
    smem_limit: int = MAX_SMEM
    smem_library: int | None = None  # the built library's count (card)
    operands: list = field(default_factory=list)
    preconditions: list = field(default_factory=list)   # (what, holds)
    coverage: list = field(default_factory=list)        # (what, holds)
    mismatch: list = field(default_factory=list)   # launched vs derived
    launch: dict = field(default_factory=dict)     # the derived knobs

    def points(self):
        """Every grid point (corners only past :data:`MAX_PROBE`)."""
        if math.prod(self.grid) <= MAX_PROBE:
            return itertools.product(*(range(g) for g in self.grid))
        return itertools.product(*(sorted({0, max(g - 1, 0)})
                                   for g in self.grid))


# ---- the entry kernels' launch formulas (csrc/knn.cu, flash_attention.cu,
# ---- ssd_chunk.cu), copied as tiling.py copies the FC kernels' ------------

KNN_WARPS, KNN_TILE, KNN_BUF = 8, 1024, 96
KNN_SCRATCH_BUDGET = 256 << 20
# SSD_QMAX: the longest chunk of ssd_chunk's "whole" route (the tiled
# route takes longer ones: SSD_TILE-row strips in pairs, an x stage of
# SSD_TILE rows by SSD_TILED_LDX, a block's S tile of the states
# SSD_TILED_SS wide, C.B^T staged SSD_TILED_SC columns of S at a time);
# FLASH_DMAX: the widest head off flash's split route
SSD_QMAX, SSD_ST, SSD_PT, SSD_MAX_HEADS = 128, 128, 64, 16
SSD_TILE, SSD_TILED_LDX, SSD_TILED_SS, SSD_TILED_SC = 64, 68, 64, 32
FLASH_DMAX = 256
# flash_split.cuh: a block's rows, its tile (keys in the forward and dQ
# pass, query rows in the dK/dV pass; in fp32 the dQ and the dK/dV
# pass's apart), the columns the forward, the dQ pass and the dK/dV pass
# hold, blocks a cluster at most (the dK/dV pass's: a non-portable
# cluster), the widest slice kept in shared memory and the piece a wider
# one streams in
SPLIT_ROWS, SPLIT_TILE, SPLIT_DQ_TILE_F32, SPLIT_DKV_TILE_F32 = 64, 32, 32, 16
SPLIT_WMAX, SPLIT_DQ_WMAX, SPLIT_DKV_WMAX, SPLIT_CLUSTER = 256, 256, 128, 8
SPLIT_DKV_CLUSTER, SPLIT_RES_MAX, SPLIT_PIECE = 16, 256, 128


def knn_plan(s: int, n: int, k: int, sms: int) -> dict:
    """``knn.cu``'s ``make_plan``: warps a center ``w``, list registers a
    lane ``r`` (0: lists in memory), the list length ``l`` and capacity,
    center groups of ``8 // w``, the grid, shared memory and scratch."""
    w_max = KNN_WARPS if k > 128 else 2
    w = 1
    while w < w_max and 2 * s * w <= 16 * sms and n >= 64 * w:
        w *= 2
    ln = (-(-n // w) + 31) // 32 * 32
    kcap = min(k, ln)
    r = (kcap + 31) // 32 if kcap <= 8 * 32 else 0
    base = 4 * 10 * KNN_TILE + 8 * KNN_WARPS * KNN_BUF
    lists = ((8 * KNN_WARPS * kcap if w > 1 else 0) if r > 0
             else 16 * KNN_WARPS * kcap)
    groups = -(-s // (KNN_WARPS // w))
    if base + lists <= MAX_SMEM - STATIC_SMEM:
        smem, grid, scratch = base + lists, groups, 0
    else:
        blocks = max(KNN_SCRATCH_BUDGET // lists, 1)
        smem, grid = base, min(blocks, groups)
        scratch = grid * lists
    return dict(w=w, r=r, l=ln, kcap=kcap, groups=groups, grid=grid,
                smem=smem, scratch=scratch)


def split_bufs(one: int, part: int) -> int:
    """``flash_split.cuh``'s ``bufs``: two buffers of partial tiles (of
    ``part`` bytes) where they fit and cost no block an SM (two blocks at
    most), else one; ``one``: the pass's bytes with one."""
    def blocks(b):
        return min(SMEM_SM // (b + STATIC_SMEM), 2)
    return (2 if one + part <= MAX_SMEM and blocks(one + part) >= blocks(one)
            else 1)


def split_plan(d: int, wmax: int,
               cmax: int = SPLIT_CLUSTER) -> tuple[int, int, int, int, bool]:
    """``flash_split.cuh``'s ``plan`` for a pass holding ``wmax`` columns:
    D cut into ``c`` slices (ceil(D / wmax) where that is at most
    ``cmax``, else SPLIT_CLUSTER) of ``w`` columns (a multiple of 16)
    over a cluster's blocks; a slice up to SPLIT_RES_MAX padded to ``wp``
    (128, 192 or 256), one sweep, a wider one ``stream``ed in pieces of
    ``wp`` = SPLIT_PIECE, one sweep a piece."""
    c = -(-d // wmax)
    c = c if c <= cmax else SPLIT_CLUSTER
    w = round_up(-(-d // c), 16)
    if w > SPLIT_RES_MAX:
        return c, w, SPLIT_PIECE, -(-w // SPLIT_PIECE), True
    return c, w, 128 if w <= 128 else 192 if w <= 192 else 256, 1, False


def flash_layout(route: str, dtype: str, d: int) -> dict:
    """``flash_attention.cu``'s tiles for a route: query rows a block
    ``bq``, keys a tile ``bk``, D padded ``dp`` (a block's slice of it on
    the split routes), shared memory, blocks a cluster and columns of D a
    block; on the split routes the backward's passes too
    (``dq_cluster``, ``dq_slice``, ``dq_smem``, ``dkv_*``) and each
    pass's sweeps.  ``split``: ``flash_split.cuh`` (``split_plan``; fp32
    partial tiles of 64 rows by 32 exchanged (by 16 in the fp32 dK/dV
    pass); a resident slice: q and two stages of K and V in the forward,
    q, dO and one or two stages of K and V in the dQ pass, K, V and two
    stages of q, dO and their rows in the dK/dV pass, ``split_bufs``
    buffers of the partials; a streamed one: one stage of each pass's
    pieces, rows SPLIT_PIECE + 8 apart (fp32 V + 4), one buffer)."""
    if route == "split":
        sz = 4 if dtype == "float32" else 2
        rows, tile = SPLIT_ROWS, SPLIT_TILE
        ldp = SPLIT_PIECE + 8
        part = 4 * rows * tile                   # one partial tile
        c, w, wp, sw, stream = split_plan(d, SPLIT_WMAX)
        if stream:
            fwd = part + sz * ((rows + tile) * ldp
                               + tile * (ldp - 4 if sz == 4 else ldp))
        else:
            ld = wp + 8
            ld_v = wp + 4 if sz == 4 else ld
            fwd = part + sz * (rows * ld + 2 * tile * ld + 2 * tile * ld_v)
            fwd += (split_bufs(fwd, part) - 1) * part
        cq, wq, wpq, swq, stream = split_plan(d, SPLIT_DQ_WMAX)
        tile = SPLIT_DQ_TILE_F32 if sz == 4 else SPLIT_TILE
        part = 4 * rows * tile
        if stream:
            dq = 2 * part + sz * 2 * (rows + tile) * ldp + 4 * 2 * rows
        else:
            ld = wpq + 8
            fixed = 2 * part + sz * 2 * rows * ld + 4 * 2 * rows
            stage = sz * 2 * tile * ld
            dq = fixed + (2 if fixed + 2 * stage <= MAX_SMEM else 1) * stage
            dq += (split_bufs(dq, 2 * part) - 1) * 2 * part
        ck, wk, wpk, swk, stream = split_plan(d, SPLIT_DKV_WMAX,
                                              SPLIT_DKV_CLUSTER)
        tile = SPLIT_DKV_TILE_F32 if sz == 4 else SPLIT_TILE
        part = 4 * rows * tile
        if stream:
            dkv = 2 * part + sz * 2 * (rows + tile) * ldp + 4 * 2 * tile
        else:
            ldk = wpk + 8
            dkv = (2 * part + sz * 2 * rows * ldk
                   + 2 * (sz * 2 * tile * ldk + 2 * tile * 4))
            dkv += (split_bufs(dkv, 2 * part) - 1) * 2 * part
        return dict(bq=rows, bk=SPLIT_TILE, dp=wp, smem=fwd, cluster=c,
                    slice=w, dq_cluster=cq, dq_slice=wq, dq_smem=dq,
                    dkv_cluster=ck, dkv_slice=wk, dkv_smem=dkv, sweeps=sw,
                    dq_sweeps=swq, dkv_sweeps=swk)
    if route == "wgmma":
        dp = 64 if d <= 64 else 128
        tile = dp // 64 * 128 * 128          # kHalves x 128 rows x 128 B
        return dict(bq=128, bk=128, dp=dp,
                    smem=tile * 5 + 8 * 9 + 1024)
    dp = 64 if d <= 64 else 128 if d <= 128 else 256
    f32 = dtype == "float32"
    warps = 4 if dp == 256 else 8
    bq, bk = 16 * warps, 32 if dp == 256 else 64
    ld_v = dp + 4 if f32 else dp + 8
    elems = bq * (dp + 8) + 2 * bk * (dp + 8) + 2 * bk * ld_v
    return dict(bq=bq, bk=bk, dp=dp, smem=(4 if f32 else 2) * elems)


def flash_route(dtype: str, d: int, aligned: bool) -> str:
    """``ops._variant``: split for D > FLASH_DMAX, wgmma for 16-byte
    aligned bf16 with D % 8 == 0 and D <= 128, else mma."""
    if d > FLASH_DMAX:
        return "split"
    return ("wgmma" if dtype == "bfloat16" and d % 8 == 0 and d <= 128
            and aligned else "mma")


def ssd_tiled_smem(n: int, w: int, qv: int) -> int:
    """``tl::smem_bytes``: a block's strips of C.B^T in a window of w j
    tiles, two x stages, the window's rows of B in its S tile and the
    vectors."""
    cb = SSD_TILE * (SSD_TILE * min(2 * w, n + 1) + 16)
    return 4 * (cb + 2 * SSD_TILE * SSD_TILED_LDX
                + SSD_TILE * w * (SSD_TILED_SS + 4) + 7 * qv + 2 * SSD_TILE)


def ssd_plan(bn: int, h: int, q: int, p: int, s: int, sms: int) -> dict:
    """``ssd_chunk.cu``'s launch: q padded ``qp``, heads a block ``hg``
    (``heads_per_block``), the grid and shared memory; ``tiled`` for the
    tiled route (q > SSD_QMAX: per (chunk, group of hg heads) a block a
    role, y of a strip pair and the states of a 64-column S tile,
    ``window`` j tiles at a time, one block an SM, hg for whole waves)."""
    if q > SSD_QMAX:
        n = -(-q // SSD_TILE)
        roles = max((n + 1) // 2, -(-s // SSD_TILED_SS))
        qv = n * SSD_TILE
        w = next((w for w in range(n, 0, -1)
                  if ssd_tiled_smem(n, w, qv) <= MAX_SMEM - STATIC_SMEM), 0)
        pp = -(-p // SSD_PT) * float(SSD_PT)
        tiles = (n + 1) * float(SSD_TILE * SSD_TILE)
        head = tiles * pp + pp * SSD_TILED_SS * qv
        cb = tiles * round_up(s, SSD_TILED_SC)
        best, best_cost = 1, 0.0
        for hg in range(1, h + 1):
            gy = -(-h // hg) * roles
            if gy > 65535:
                continue
            cost = -(-(bn * gy) // sms) * (hg * head + cb)
            if best_cost == 0 or cost < best_cost:
                best, best_cost = hg, cost
        return dict(qp=qv, hg=best, grid=(bn, -(-h // best) * roles),
                    smem=ssd_tiled_smem(n, max(w, 1), qv), tiled=1,
                    window=w)
    qp = round_up(q, 16)
    ldcb = round_up(qp, 32) + 8
    smem = 4 * (qp * (SSD_ST + 4) + qp * ldcb + 2 * qp * (SSD_PT + 4)
                + 5 * qp)
    slots = (1 if SMEM_SM // (smem + 1024) < 2 else 2) * sms
    pp, sp = round_up(p, 8), round_up(s, 8)
    head = qp * (qp / 2.0 + 8) * pp + pp * sp * qp
    cb = float(qp) * qp * sp
    best, best_cost = 1, 0.0
    for hg in range(1, min(SSD_MAX_HEADS, h) + 1):
        blocks = bn * -(-h // hg)
        cost = -(-blocks // slots) * (hg * head + cb)
        if hg == 1 or cost < best_cost:
            best, best_cost = hg, cost
    return dict(qp=qp, hg=best, grid=(bn, -(-h // best)), smem=smem,
                tiled=0)


# ---- sites from captured plans --------------------------------------------

def _gather_mlp_site(dims, plan, where, sms, card):
    b, s, k, d, dc, h, f = (dims[n] for n in ("b", "s", "k", "d", "dc",
                                              "h", "f"))
    per_cloud = plan.get("variant") == "per_cloud"
    nb, bb = (b, 1) if per_cloud else (1, b)
    forced = plan.get("provenance") in ("override", "autotuned")
    way = tiling.route(k, d, dc, h, f)
    mismatch = []
    if plan.get("route") not in (None, way):
        mismatch.append(f"route {plan['route']} launched, {way} derived")
    if way == "linear":
        # two kernels a call: W split into its TF32 halves in scratch,
        # then the product; the site holds the product's grid (row-tile
        # groups, F tiles)
        lp = tiling.linear_plan(bb, s, k, f, sms,
                                (plan.get("rows") or 0) if forced else 0)
        rows, spt = lp["rows"], lp["spt"]
        if plan.get("rows") is not None and plan["rows"] != rows:
            mismatch.append(f"rows {plan['rows']} launched, {rows} derived")
        site = KernelSite(
            "gather_mlp", where, dims, plan,
            grid=(nb, lp["groups"], lp["nft"]),
            semantics=(PARALLEL, PARALLEL, PARALLEL),
            out_shape=(nb, bb * s, f),
            out_block=(1, spt, lp["n"]),
            out_map=lambda p: [(p[0], p[1], p[2])], smem=lp["smem"],
            launch=dict(route=way, **lp, kernels=2,
                        scratch=tiling.linear_scratch(d, f)),
            preconditions=[
                (f"row tile {rows} in {tiling.ROWS}", rows in tiling.ROWS),
                (f"{lp['n']} columns a block, a multiple of "
                 f"{tiling.LINEAR_TILE_COLS} and at most "
                 f"{tiling.LINEAR_MAX_COLS}",
                 lp["n"] % tiling.LINEAR_TILE_COLS == 0
                 and 0 < lp["n"] <= tiling.LINEAR_MAX_COLS),
                (f"{spt} subsets of {max(k, 1)} rows fit a {rows}-row tile",
                 spt * max(k, 1) <= rows or spt == 1)],
            coverage=[
                (f"{lp['n_tiles']} row tiles of {rows} cover a subset's "
                 f"{k} rows", lp["n_tiles"] * rows >= k)])
        knobs = ((plan.get("rows") or 0) if forced else 0, 0)
    elif way == "narrow":
        rows = tiling.narrow_rows(bb, s, k, d, dc, h, f, sms,
                                  (plan.get("rows") or 0) if forced else 0)
        if plan.get("rows") is not None and plan["rows"] != rows:
            mismatch.append(f"rows {plan['rows']} launched, {rows} derived")
        kp = tiling.padded_k(k)
        spt = rows // kp if kp <= rows else 1
        groups = -(-(bb * s) // spt)
        xh = max(round_up(d, 8), round_up(h, 8))
        smem = tiling.narrow_smem(rows, k, d, dc, h, f)
        site = KernelSite(
            "gather_mlp", where, dims, plan, grid=(nb, groups),
            semantics=(PARALLEL, PARALLEL), out_shape=(nb, bb * s, f),
            out_block=(1, spt, f), out_map=lambda p: [(p[0], p[1], 0)],
            smem=smem, launch=dict(route=way, rows=rows, spt=spt),
            operands=[OperandInfo("x|h row tile", (rows, xh),
                                  (rows, tiling._stride(xh)), True)],
            preconditions=[
                (f"row tile {rows} in {tiling.ROWS}", rows in tiling.ROWS),
                (f"padded K {kp} a multiple of 16", kp % 16 == 0),
                (f"{spt} subsets of {kp} rows fit a {rows}-row tile",
                 spt * kp <= rows or spt == 1)])
        knobs = ((plan.get("rows") or 0) if forced else 0, 0)
    else:
        n_knob = (plan.get("nsplit") or 0) if forced else 0
        wp = tiling.wide_plan(bb, s, k, d, dc, h, f, sms, n_knob)
        if plan.get("nsplit") is not None and plan["nsplit"] != wp["nsplit"]:
            mismatch.append(f"nsplit {plan['nsplit']} launched, "
                            f"{wp['nsplit']} derived")
        nchunk = tiling.wide_chunks(h)
        spt, ft = wp["spt"], wp["ft"]
        ops = []
        if wp["resident"]:
            ops.append(OperandInfo("x", (64, d), (64, tiling._stride(
                round_up(d, 8))), True))
        site = KernelSite(
            "gather_mlp", where, dims, plan,
            grid=(nb, wp["groups"], wp["nft"], wp["nsplit"]),
            semantics=(PARALLEL, PARALLEL, PARALLEL, MERGE),
            out_shape=(nb, bb * s, f), out_block=(1, spt, ft),
            out_map=lambda p: [(p[0], p[1], p[2])], smem=wp["smem"],
            launch=dict(route=way, **wp), operands=ops,
            preconditions=[
                (f"F tile {ft} a multiple of 64 and at most 256",
                 ft % 64 == 0 and 0 < ft <= 256),
                (f"{spt} subsets of {max(k, 1)} rows fit a 64-row tile",
                 spt * max(k, 1) <= 64 or spt == 1)],
            coverage=[
                (f"{wp['nsplit']} splits of {wp['cps']} chunks cover H's "
                 f"{nchunk}, none empty",
                 wp["nsplit"] * wp["cps"] >= nchunk
                 and (wp["nsplit"] - 1) * wp["cps"] < nchunk)])
        knobs = (0, n_knob)
    if card:
        from ..kernels.gather_mlp import ops
        site.smem_library = ops.library_smem(bb, s, k, d, dc, h, f, *knobs)
        if way == "linear":
            lib = ops.library_linear_plan(bb, s, k, d, dc, f, knobs[0])
            ours = {n: site.launch[n] for n in ops.LINEAR_PLAN
                    if n != "x_tma"}
            if lib is None or {n: lib[n] for n in ours} != ours:
                mismatch.append(f"linear plan {lib} from the library, "
                                f"{ours} derived")
        if way == "wide":
            lib = ops.library_plan(bb, s, k, d, dc, h, f, knobs[1])
            ours = {n: site.launch[n] for n in ops.PLAN}
            if lib != ours:
                mismatch.append(f"wide plan {lib} from the library, "
                                f"{ours} derived")
    site.mismatch = mismatch
    return site


def _hub_reuse_site(dims, plan, where, sms, card):
    b, hn, c, m, k, d, h, f = (dims[n] for n in ("b", "hn", "c", "m", "k",
                                                 "d", "h", "f"))
    per_cloud = plan.get("variant") == "per_cloud"
    nb, bb = (b, 1) if per_cloud else (1, b)
    route = tiling.hub_reuse_route(bb, hn, c, m, k, d, f, sms, h=h)
    nf = -(-f // 64)
    mismatch = ([] if plan.get("route") in (None, route) else
                [f"route {plan['route']} launched, {route} derived"])
    if route == "layered":
        # three kernels a call in two layers: layer 1, layer 2 (H split),
        # the gather; two in one (h = 0): x·W (D split), the gather.  The
        # site holds the gather's grid (islands x subset tiles, feature
        # tiles); nothing stages the slot table
        lp = tiling.hub_reuse_layered_plan(bb, hn, c, h, f, sms, d)
        depth, what = (d, "x·W's") if h == 0 else (h, "layer 2's")
        mt = -(-m // tiling.GATHER_SUBSETS)
        site = KernelSite(
            "hub_reuse", where, dims, plan,
            grid=(nb, bb * hn * mt, nf),
            semantics=(PARALLEL, PARALLEL, PARALLEL),
            out_shape=(nb, bb * hn * mt, f), out_block=(1, 1, 64),
            out_map=lambda p: [p],
            smem=tiling.LAYERED_SMEM,
            launch=dict(route=route, chunk=None, launches=[c],
                        nsplit=lp["nsplit"], scratch=lp["scratch"]),
            operands=[OperandInfo("slot table", (m, k), (1, 32), False)],
            preconditions=[(f"chunk {plan.get('chunk')} is None on the "
                            f"layered route", plan.get("chunk") is None)],
            coverage=[(f"{what} {lp['nsplit']} splits of {lp['kper']} "
                       f"rows cover {'D' if h == 0 else 'H'}={depth}",
                       (lp["nsplit"] - 1) * lp["kper"] < depth
                       <= lp["nsplit"] * lp["kper"])],
            mismatch=mismatch)
        if card:
            from ..kernels.hub_reuse import ops
            lib = ops.library_plan(bb, hn, c, m, k, d, h, f)
            site.smem_library = lib["smem"]
            ours = dict(route=route, nsplit=lp["nsplit"],
                        scratch=lp["scratch"])
            theirs = {n: lib[n] for n in ours}
            if theirs != ours:
                site.mismatch.append(f"layered plan {theirs} from the "
                                     f"library, {ours} derived")
        return site
    chunk = plan.get("chunk") or tiling.hub_reuse_chunk(c, m, k, d, h)
    launches = tiling.hub_reuse_launches(c, chunk)
    if h == 0 and tiling.reuse_linear_wgmma(bb, hn, c, d, f):
        # one layer on wgmma: W's split, then a persistent grid over items
        # (a row tile of ipt whole islands by n columns); the site holds
        # each launch's items, nothing stages the slot table
        lp = tiling.reuse_linear_plan(bb, hn, c, d, f, sms, chunk)
        ipt, n, isl = lp["ipt"], lp["n"], bb * hn

        def item_tiles(p):
            g, ft = p[2] // lp["nft"], p[2] % lp["nft"]
            cols = [t for t in range(ft * n // 64, (ft + 1) * n // 64)
                    if t * 64 < f]
            return [(p[0], i, t) for i in range(g * ipt,
                                                min(isl, (g + 1) * ipt))
                    for t in cols]
        site = KernelSite(
            "hub_reuse", where, dims, plan,
            grid=(nb, len(launches), lp["items"]),
            semantics=(PARALLEL, MERGE, PARALLEL),
            out_shape=(nb, isl, f), out_block=(1, 1, 64),
            out_map=item_tiles,
            smem=lp["smem"],
            launch=dict(route=route, chunk=chunk, launches=launches,
                        rows=lp["rows"], ipt=ipt, n=n, items=lp["items"],
                        scratch=lp["scratch"]),
            operands=[OperandInfo("slot table", (m, k), (1, 32), False)],
            preconditions=[(f"chunk {chunk} in {tiling.CHUNKS}",
                            chunk in tiling.CHUNKS),
                           (f"a {lp['rows']}-row tile holds {ipt} whole "
                            f"islands of {min(chunk, c)} rows",
                            ipt >= 1 and ipt * min(chunk, c) <= lp["rows"])],
            coverage=[(f"launches {launches} cover the {c} cache rows",
                       sum(launches) == c and all(0 < r <= chunk
                                                  for r in launches))],
            mismatch=mismatch)
        if card:
            from ..kernels.hub_reuse import ops
            site.smem_library = ops.library_smem(bb, hn, c, m, k, d, h, f,
                                                 True, chunk)
            lib = ops.library_linear_plan(bb, hn, c, m, k, d, f, chunk)
            # (x_tma: the library's also asks the pool's alignment)
            if lib is None or any(lib[key] != lp[key]
                                  for key in ops.LINEAR_PLAN
                                  if key != "x_tma"):
                site.mismatch.append(f"one-layer plan {lib} from the "
                                     f"library, {lp} derived")
        return site
    site = KernelSite(
        "hub_reuse", where, dims, plan,
        grid=(nb, len(launches), bb * hn, nf),
        semantics=(PARALLEL, MERGE, PARALLEL, PARALLEL),
        out_shape=(nb, bb * hn, f), out_block=(1, 1, 64),
        out_map=lambda p: [(p[0], p[2], p[3])],
        smem=tiling.hub_reuse_smem(c, m, k, d, True, chunk, h),
        launch=dict(route=route, chunk=chunk, launches=launches),
        operands=[OperandInfo("slot table", (m, k), (m, round_up(k, 4)),
                              True)],
        preconditions=[(f"chunk {chunk} in {tiling.CHUNKS}",
                        chunk in tiling.CHUNKS)],
        coverage=[(f"launches {launches} cover the {c} cache rows",
                   sum(launches) == c and all(0 < r <= chunk
                                              for r in launches))],
        mismatch=mismatch)
    if card:
        from ..kernels.hub_reuse import ops
        site.smem_library = ops.library_smem(bb, hn, c, m, k, d, h, f, True,
                                             chunk)
        lib_route = ops.library_plan(bb, hn, c, m, k, d, h, f)["route"]
        if lib_route != route:
            site.mismatch.append(f"route {lib_route} from the library, "
                                 f"{route} derived")
    return site


def _knn_site(dims, plan, where, sms, card):
    s, n, k = dims["s"], dims["n"], dims["k"]
    kp = knn_plan(s, n, k, sms)
    per = KNN_WARPS // kp["w"]
    grid, groups = kp["grid"], kp["groups"]
    mismatch = [f"{key} {plan[key]} launched, {kp[key]} derived"
                for key in ("w", "r", "grid") if plan.get(key) is not None
                and plan[key] != kp[key]]
    if plan.get("scratch") is not None and plan["scratch"] != (
            kp["scratch"] > 0):
        mismatch.append(f"scratch {plan['scratch']} launched, "
                        f"{kp['scratch'] > 0} derived")
    site = KernelSite(
        "knn", where, dims, plan, grid=(grid,), semantics=(PARALLEL,),
        out_shape=(s, k), out_block=(per, k),
        # the blocks walk the center groups grid-stride
        out_map=lambda p: [(g, 0) for g in range(p[0], groups, grid)],
        smem=kp["smem"], smem_limit=MAX_SMEM - STATIC_SMEM, launch=kp,
        preconditions=[
            (f"{kp['w']} warps a center divide the block's {KNN_WARPS}",
             KNN_WARPS % kp["w"] == 0),
            (f"list of {kp['kcap']} fits {kp['r']} registers a lane, "
             f"shared memory or scratch",
             kp["kcap"] <= kp["l"] and (0 < 32 * kp["r"] >= kp["kcap"]
                                        or kp["r"] == 0))],
        mismatch=mismatch)
    if card and s * k:
        from ..kernels.knn import ops
        site.smem_library = ops.library_smem(s, n, k)
    return site


def _flash_site(dims, plan, where, sms, card):
    b, hq, hkv, sq, skv, d = (dims[n] for n in ("b", "hq", "hkv", "sq",
                                                "skv", "d"))
    dtype = plan.get("dtype", "float32")
    route = flash_route(dtype, d, bool(plan.get("aligned", True)))
    mismatch = ([] if plan.get("route") in (None, route) else
                [f"route {plan['route']} launched, {route} derived"])
    lay = flash_layout(route, dtype, d)
    bq = lay["bq"]
    split = route == "split"
    pre = [(f"D={d} in 1..{FLASH_DMAX} off the split route",
            0 < d and (split or d <= FLASH_DMAX)),
           (f"Hq={hq} a multiple of Hkv={hkv}", hkv > 0 and hq % hkv == 0)]
    if route == "split":
        for name, c, w, most in (
                ("forward and dQ", lay["cluster"], lay["slice"],
                 SPLIT_CLUSTER),
                ("dK/dV", lay["dkv_cluster"], lay["dkv_slice"],
                 SPLIT_DKV_CLUSTER)):
            pre.append((f"split {name}: {c} blocks a cluster (at most "
                        f"{most}) of {w} columns cover D={d} and none lies "
                        f"past it", c <= most and (c - 1) * w < d <= c * w))
    if route == "wgmma":
        pre += [(f"wgmma takes bf16, got {dtype}", dtype == "bfloat16"),
                (f"wgmma's rows of D={d} bf16 are 16-byte multiples",
                 d % 8 == 0 and d <= 128),
                ("wgmma's TMA bases 16-byte aligned",
                 bool(plan.get("aligned", True)))]
    # the split route's grids also run D's slices (the blocks of a
    # cluster)
    if split:
        grid, out_shape, out_block = ((b * hq, -(-sq // bq),
                                       -(-d // lay["slice"])),
                                      (b * hq, sq, d), (1, bq, lay["slice"]))
    else:
        grid, out_shape, out_block = ((b * hq, -(-sq // bq)), (b * hq, sq),
                                      (1, bq))
    site = KernelSite(
        "flash_attention", where, dims, plan, grid=grid,
        semantics=(PARALLEL,) * len(grid), out_shape=out_shape,
        out_block=out_block, out_map=lambda p: [p], smem=lay["smem"],
        launch=dict(route=route, **lay), preconditions=pre,
        mismatch=mismatch)
    if card and 0 < d:
        from ..kernels.flash_attention import ops
        lib = ops.library_layout(route, dtype, d)
        site.smem_library = lib["smem"]
        ours = {n: lay[n] for n in ("bq", "bk", "dp")}
        if split:
            ours.update({n: lay[n] for n in lay if n not in ("smem", *ours)})
        theirs = {n: lib.get(n) for n in ours}
        if theirs != ours:
            site.mismatch.append(f"{route} tiles {theirs} from the "
                                 f"library, {ours} derived")
    return site


def _ssd_site(dims, plan, where, sms, card):
    bn, h, q, p, s = (dims[n] for n in ("bn", "h", "q", "p", "s"))
    sp = ssd_plan(bn, h, q, p, s, sms)
    hg = sp["hg"]
    way = "tiled" if sp["tiled"] else "whole"
    site = KernelSite(
        "ssd_chunk", where, dims, plan, grid=sp["grid"],
        semantics=(PARALLEL, PARALLEL),
        # the tiled route: a block a (chunk, group, role), its own rows
        out_shape=(bn, sp["grid"][1] if sp["tiled"] else h),
        out_block=(1, 1 if sp["tiled"] else hg), out_map=lambda pt: [pt],
        smem=sp["smem"],
        smem_limit=MAX_SMEM - STATIC_SMEM, launch=dict(route=way, **sp),
        preconditions=[
            (f"chunk q={q} in 1..{SSD_QMAX} on the whole route",
             0 < q and (sp["tiled"] or q <= SSD_QMAX)),
            (f"{hg} heads a block in 1..{h if sp['tiled'] else SSD_MAX_HEADS}",
             0 < hg <= (h if sp["tiled"] else SSD_MAX_HEADS))],
        mismatch=([] if plan.get("route") in (None, way) else
                  [f"route {plan['route']} launched, {way} derived"]))
    if card and q > 0:
        from ..kernels.ssd_chunk import ops
        lib = ops.library_plan(bn, h, q, p, s)
        site.smem_library = lib["smem"]
        theirs = dict(qp=lib["qp"], hg=lib["hg"],
                      grid=(lib["grid_x"], lib["grid_y"]),
                      tiled=lib.get("tiled", sp["tiled"]))
        ours = dict(qp=sp["qp"], hg=hg, grid=tuple(sp["grid"]),
                    tiled=sp["tiled"])
        if theirs != ours:
            site.mismatch.append(f"plan {theirs} from the library, {ours} "
                                 f"derived")
    return site


_DERIVE = {"gather_mlp": _gather_mlp_site, "hub_reuse": _hub_reuse_site,
           "knn": _knn_site, "flash_attention": _flash_site,
           "ssd_chunk": _ssd_site}


def site_from_capture(entry: dict, where: str, *, sms: int | None = None,
                      card: bool = False) -> KernelSite:
    """The site of one captured call (``{"kernel", "dims", "plan"}``).
    ``card``: the call ran on the card, so the built libraries answer
    for their own shared memory and plans (and must agree)."""
    return _DERIVE[entry["kernel"]](entry["dims"], entry["plan"], where,
                                    HW["sms"] if sms is None else sms, card)


def kernel_sites(captured, where: str = "capture", *,
                 sms: int | None = None, card: bool = False) -> list:
    """Sites of every captured call a lint knows (numbered per kernel)."""
    seen: dict = {}
    out = []
    for entry in captured:
        kernel = entry["kernel"]
        if kernel not in _DERIVE:
            continue
        i = seen[kernel] = seen.get(kernel, -1) + 1
        out.append(site_from_capture(entry, f"{where}/{kernel}#{i}",
                                     sms=sms, card=card))
    return out


# ---- the rules -------------------------------------------------------------

def check_kernel_site(site: KernelSite) -> list[Finding]:
    out: list[Finding] = []
    if site.smem > site.smem_limit:
        out.append(Finding(
            "K001", f"{site.smem} B of shared memory a block, past the "
                    f"kernel's {site.smem_limit} (grid={site.grid})",
            where=site.where))
    if site.smem_library is not None and site.smem_library != site.smem:
        out.append(Finding(
            "K001", f"tiling's {site.smem} B of shared memory != the "
                    f"library's {site.smem_library}", where=site.where))
    for what, holds in site.preconditions:
        if not holds:
            out.append(Finding("K002", f"precondition fails: {what}",
                               where=site.where))
    for what in site.mismatch:
        out.append(Finding("K003", f"the launched plan differs from the "
                                   f"derived one: {what}", where=site.where))
    for what, holds in site.coverage:
        if not holds:
            out.append(Finding("K003", f"coverage fails: {what}",
                               where=site.where))
    if len(site.semantics) != len(site.grid):
        out.append(Finding(
            "K005", f"semantics {site.semantics} has rank "
                    f"{len(site.semantics)} but the grid {site.grid} has "
                    f"rank {len(site.grid)}", where=site.where))
        return out

    need = tuple(-(-a // bk) for a, bk in zip(site.out_shape,
                                              site.out_block))
    writers: dict = {}
    outside = empty = None
    for point in site.points():
        tiles = site.out_map(point)
        inside = [t for t in tiles
                  if all(0 <= ti < n for ti, n in zip(t, need))]
        if len(inside) < len(tiles) and outside is None:
            outside = (point, [t for t in tiles if t not in inside][0])
        if not tiles and empty is None:
            empty = point
        for t in inside:
            writers.setdefault(t, []).append(point)
    if outside is not None:
        out.append(Finding(
            "K003", f"block {outside[0]} writes tile {outside[1]}, wholly "
                    f"outside the output {site.out_shape} in tiles of "
                    f"{site.out_block}", where=site.where))
    if empty is not None:
        out.append(Finding(
            "K003", f"block {empty} of grid {site.grid} writes no tile",
            where=site.where))
    if math.prod(site.grid) <= MAX_PROBE and len(writers) < math.prod(
            need):
        missing = next(t for t in itertools.product(*(range(n)
                                                      for n in need))
                       if t not in writers)
        out.append(Finding(
            "K003", f"grid {site.grid} leaves output tile {missing} of "
                    f"{need} unwritten (output {site.out_shape}, tiles of "
                    f"{site.out_block})", where=site.where))

    merge = {a for a, s in enumerate(site.semantics) if s == MERGE}
    for t, pts in writers.items():
        first = pts[0]
        clash = next((q for q in pts[1:] if any(
            a not in merge and q[a] != first[a] for a in range(len(first)))),
            None)
        if clash is not None:
            out.append(Finding(
                "K005", f"blocks {first} and {clash} both write output "
                        f"tile {t} and the plan does not merge them "
                        f"(semantics {site.semantics})", where=site.where))
            break

    for o in site.operands:
        if o.resident and not all(bd >= ad for bd, ad in
                                  zip(o.block_shape, o.array_shape)):
            out.append(Finding(
                "K004", f"{o.name} is resident but its block "
                        f"{o.block_shape} does not cover {o.array_shape}",
                where=site.where))
    return out


def kernel_findings(sites) -> list[Finding]:
    """Run K001–K005 over every site."""
    out: list[Finding] = []
    for site in sites:
        out.extend(check_kernel_site(site))
    return out


def plan_site(kernel: str, dims: dict, knobs: dict, *, sms: int,
              card: bool = False, where: str = "autotune") -> KernelSite:
    """The site of the launch one FC plan makes (``knobs``: a tile plan's
    knob fields, or ``{"variant": "per_cloud"}``); ``card``: with the
    library's own shared memory and wide plan beside the formulas'."""
    plan = {"provenance": "override", "variant": knobs.get("variant"),
            **{n: knobs.get(n) for n in tiling.KNOBS[kernel]}}
    if kernel == "hub_reuse" and "variant" not in knobs:
        plan["chunk"] = (knobs.get("chunk", tiling.hub_reuse_chunk(
            *(dims[n] for n in ("c", "m", "k", "d")), dims.get("h")))
            if tiling.knobs_of(kernel, dims, sms) else None)
    elif kernel == "hub_reuse":        # per cloud: its launches' own route
        one = dict(dims, b=1)
        plan["chunk"] = (tiling.hub_reuse_chunk(
            *(dims[n] for n in ("c", "m", "k", "d")), dims.get("h"))
            if tiling.knobs_of(kernel, one, sms) else None)
    return site_from_capture({"kernel": kernel, "dims": dims, "plan": plan},
                             f"{where}:{kernel}", sms=sms, card=card)


def lint_plan(kernel: str, dims: dict, knobs: dict, *, sms: int,
              card: bool = False, where: str = "autotune") -> tuple:
    """K001–K005 over the launch one FC plan makes, as the autotuner asks
    before it promotes the plan -> ``(site, findings)``."""
    site = plan_site(kernel, dims, knobs, sms=sms, card=card, where=where)
    return site, check_kernel_site(site)
