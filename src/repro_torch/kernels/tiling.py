"""Launch shapes of the two FC kernels on Hopper: the shared-memory
formulas of ``csrc/gather_mlp.cu`` and ``csrc/hub_reuse.cu``, the knobs a
tile plan sets, and whether a plan fits a block's shared memory.

The counterpart of ``repro.kernels.tiling``.  The TPU kernels tile their
grids against a VMEM budget and pad every lane dimension to 128; the CUDA
kernels take their shapes as they are (no lane padding) and are held to
a block's 227 KB of shared memory instead, so ``LANE``, ``pad_lanes``
and ``vmem_budget_mb`` have no meaning here and are not ported.  What a
plan sets, per kernel and route:

  gather_mlp, route ``narrow``  ``rows``    the row tile, 64 or 128
  gather_mlp, route ``wide``    ``nsplit``  H's 32-column chunks split
                                            across blocks, 1 to ⌈H/32⌉
  gather_mlp, route ``linear``  ``rows``    the row tile, 64 or 128
  hub_reuse, route ``resident`` ``chunk``   cache rows a launch, 64 or 128

gather_mlp's route follows from the widths alone (:func:`route`): a call
with no hidden layer (H = 0, one product) takes ``linear``; a two-layer
call ``narrow`` where a 64-row tile's x and whole h fit a block, else
``wide``.

hub_reuse has two forms, two layers and one (h = 0: y = x·W + b, the
engine's lowering of every one-layer point-MLP), and two routes, fixed
by the call's widths, its form and the card's SM count
(:func:`hub_reuse_route`): ``resident`` stages an island's x and slot
table in a block (and in two layers an h tile), for the calls one launch
of it covers (C <= 128 rows that fit) and, in 128-row chunks, for C past
128 where its grid fills most of the card; ``layered`` takes every other
call over device memory (two layers: the first layer once for all cache
rows, the second with H split where its tiles are few, the gather; one
layer: x·W with D split where its tiles are few, the gather; its plan,
:func:`hub_reuse_layered_plan`, depends on the SM count too).  A
one-layer resident call large enough (:func:`reuse_linear_wgmma`) takes
a kernel of its own on wgmma instead (:func:`reuse_linear_plan`: W's
halves split once a call and x streamed, row tiles of whole islands, the
gather in its epilogue).

The formulas mirror the kernels' own (``smem_bytes`` and
``wide::make_plan`` and ``linear::smem_bytes`` in ``gather_mlp.cu``,
``smem_bytes``, ``layered_route``, ``layered::plan`` and ``rl::plan`` in
``hub_reuse.cu``); each library also answers for itself
(``gather_mlp_smem_bytes``, ``hub_reuse_smem_bytes``, ``hub_reuse_plan``,
``hub_reuse_linear_plan``), which ``chip_smoke.py`` holds these
against.
"""
from __future__ import annotations

MAX_SMEM = 232448          # a block's shared memory on Hopper, bytes
SMEM_SM = 233472           # an SM's shared memory, bytes
WIDE_BLOCKS_PER_SM = 2     # what the wide route's plan aims at (kBlocks)
NARROW_BLOCKS_PER_SM = 2   # what the narrow row tile aims at (kBlocksPerSM)
ROWS = (64, 128)           # the narrow route's row tiles
CHUNKS = (64, 128)         # hub_reuse's cache rows a resident launch
H_CHUNK = 32               # the wide route's columns of h a chunk
ROUTES = ("narrow", "wide", "linear")   # gather_mlp_route's 0, 1, 2
H100_SMS = 132             # the SM count planned for off the card
LAYERED_TILE = 64          # the layered route's GEMM tiles, 64 x 64
GATHER_SUBSETS = 16        # the layered gather's subsets a block
#: a layered GEMM block's shared memory: three stages of a 64 x 72 A tile
#: and a 64 x 68 B tile (the gather's, y at 64 features of at most 384
#: cache rows, is less)
LAYERED_SMEM = 4 * 3 * (64 * 72 + 64 * 68)
#: the knobs of each kernel's plans, and the route each acts on
KNOBS = {"gather_mlp": ("rows", "nsplit"), "hub_reuse": ("chunk",)}
KNOB_ROUTES = {"rows": ("narrow", "linear"), "nsplit": ("wide",),
               "chunk": ("resident",)}
LINEAR_MAX_COLS = 256      # the linear route's most output columns a block
LINEAR_TILE_COLS = 64      # its columns a block are a multiple of it
LINEAR_DEPTH = 16          # its ring stages' depth (kBK)
LINEAR_MAX_STAGES = 8      # its most ring stages (kMaxStages)
LINEAR_X_TMA = True        # its x by TMA where D % 4 == 0 (kXByTma)
LINEAR_Y_COLS = 64         # its y's columns staged at a time (kYC)


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _stride(x: int) -> int:
    """x rounded up to ≡ 8 mod 32 floats (the kernels' row strides)."""
    return x + (8 - x) % 32


def padded_k(k: int) -> int:
    """K as the narrow route pads it: to 16 (16 for K = 0)."""
    return round_up(k, 16) if k > 0 else 16


def narrow_smem(rows: int, k: int, d: int, dc: int, h: int, f: int) -> int:
    """Bytes of shared memory a block of the narrow route takes at a row
    tile of ``rows`` (``gather_mlp.cu``: ``smem_bytes``)."""
    kp = padded_k(k)
    spt = rows // kp if kp <= rows else 1
    xh = _stride(max(round_up(d, 8), round_up(h, 8)))
    return (4 * (rows * xh * (1 if h <= 128 else 2) + 2 * 32 * 132
                 + (rows // 16) * 128 + spt * (f + dc))
            + 4 * (rows + spt))


def route(k: int, d: int, dc: int, h: int, f: int) -> str:
    """The route gather_mlp takes for subsets of k points of width d,
    centers of width dc, hidden width h and output width f: ``"linear"``
    where h is 0 (one layer, whatever the widths); for two layers
    ``"narrow"`` where a 64-row tile's x and whole h fit, else ``"wide"``,
    which takes any shape."""
    if h == 0:
        return "linear"
    return "narrow" if narrow_smem(64, k, d, dc, h, f) <= MAX_SMEM else "wide"


def linear_tiles(f: int) -> tuple:
    """The linear route's F tiles and output columns a block for f
    outputs (``gather_mlp.cu``: ``linear::f_tiles``, ``linear::cols``):
    ceil(f / 256) tiles of ceil(f / tiles) columns rounded up to 64."""
    nft = -(-f // LINEAR_MAX_COLS)
    return nft, round_up(-(-f // nft), LINEAR_TILE_COLS)


def _linear_tail(rows: int, n: int) -> int:
    """Bytes after the linear route's ring: y's staging (rows x 72 fp32),
    the mbarriers (full and empty a stage), the live rows, the running
    max, its live flags and the tile's bias (``linear::tail_bytes``):
    the live rows one a consumer thread (2 · rows), the bias 256 wide."""
    return (4 * rows * (LINEAR_Y_COLS + 8) + 8 * 2 * LINEAR_MAX_STAGES
            + 8 * rows + 8 * n + 4 * LINEAR_MAX_COLS)


def linear_stage_bytes(rows: int, n: int, spt: int) -> int:
    """Bytes of a ring stage of the linear route (``linear::stage_bytes``):
    both W halves (n rows of 16 fp32 each), the x slice (row stride 24)
    and the spt centers' slice (16 each), rounded up to 1024."""
    return round_up(4 * (2 * n * LINEAR_DEPTH + rows * (LINEAR_DEPTH + 8)
                         + spt * LINEAR_DEPTH), 1024)


def linear_blocks_per_sm(n: int) -> int:
    """Blocks an SM of the linear route at ``n`` columns a block
    (``linear::blocks_per_sm``): two at 64, else one."""
    return 2 if n <= LINEAR_TILE_COLS else 1


def linear_stages(rows: int, n: int, spt: int) -> int:
    """The linear route's ring stages (``linear::ring_stages``): as many
    as fit a block's budget (a block's limit, or half an SM less its
    reserved 1 KB at two blocks an SM), at most ``LINEAR_MAX_STAGES``."""
    budget = (SMEM_SM // 2 - 1024 if linear_blocks_per_sm(n) == 2
              else MAX_SMEM)
    room = budget - 1024 - _linear_tail(rows, n)
    return min(LINEAR_MAX_STAGES, room // linear_stage_bytes(rows, n, spt))


def linear_smem(rows: int, spt: int, n: int) -> int:
    """Bytes of shared memory a block of the linear route takes at a row
    tile of ``rows`` holding ``spt`` subsets and ``n`` output columns
    (``gather_mlp.cu``: ``linear::smem_bytes``): 1024 of alignment, the
    ring of :func:`linear_stages` stages, and the tail (y staged 64
    columns at a time, mbarriers, live rows, running max, bias): 226,432
    B at 128 rows of K = 20 by 256 columns (4 stages, one block an SM),
    105,088 by 64 columns (3 stages, two blocks an SM)."""
    return (1024 + linear_stages(rows, n, spt)
            * linear_stage_bytes(rows, n, spt) + _linear_tail(rows, n))


def linear_scratch(d: int, f: int) -> int:
    """Bytes of device scratch a linear call takes: W's two TF32 halves,
    each F_pad = tiles x columns rows of D_pad = d rounded up to 16
    (``linear::scratch_bytes``)."""
    nft, n = linear_tiles(f)
    return 2 * 4 * nft * n * round_up(d, LINEAR_DEPTH)


def linear_x_tma(d: int) -> bool:
    """Whether a linear call of input width d takes x by TMA (raw
    16-byte aligned, as the wrapper's contiguous tensors are):
    ``LINEAR_X_TMA`` and rows of 16-byte multiples."""
    return LINEAR_X_TMA and d % 4 == 0


def linear_plan(b: int, s: int, k: int, f: int, sms: int,
                rows: int = 0) -> dict:
    """How the linear route tiles a call of b·s subsets of k points with
    f outputs on a card of ``sms`` SMs (``gather_mlp.cu``: ``linear::``):
    ``rows`` a tile (the knob where given, else 128, or 64 where 128-row
    tiles times the F tiles would give fewer items than 3/4 of the
    persistent grid's blocks, :func:`linear_blocks_per_sm` an SM),
    whole subsets packed k rows apart (``spt`` a tile; one subset over
    ``n_tiles`` tiles where k passes the tile), ``groups`` row-tile
    groups by ``nft`` F tiles of ``n`` columns, a ring of ``stages``
    16-deep stages, ``smem`` bytes a block."""
    def spt_of(r):
        return r // max(k, 1) if k <= r else 1

    nft, n = linear_tiles(f)
    if not rows:
        items = -(-(b * s) // spt_of(128)) * nft
        rows = 64 if 4 * items < 3 * linear_blocks_per_sm(n) * sms else 128
    spt = spt_of(rows)
    return dict(rows=rows, spt=spt, n_tiles=-(-k // rows) if k > rows else 1,
                groups=-(-(b * s) // spt), nft=nft, n=n,
                stages=linear_stages(rows, n, spt),
                smem=linear_smem(rows, spt, n))


def row_tile(b: int, s: int, k: int, sms: int) -> int:
    """The narrow route's heuristic row tile on a card of ``sms`` SMs: 64
    where 128-row tiles would give fewer than two blocks an SM, else 128
    (``gather_mlp_row_tile``)."""
    rows = b * s * padded_k(k)
    return 64 if rows // 128 < NARROW_BLOCKS_PER_SM * sms else 128


def narrow_rows(b, s, k, d, dc, h, f, sms: int, rows: int = 0) -> int:
    """The row tile a narrow call launches with: ``rows`` where forced,
    else the heuristic's, dropped to 64 where 128 rows overflow."""
    if rows:
        return rows
    r = row_tile(b, s, k, sms)
    return 64 if narrow_smem(r, k, d, dc, h, f) > MAX_SMEM else r


def wide_chunks(h: int) -> int:
    """H's 32-column chunks on the wide route: the most ``nsplit`` takes."""
    return -(-h // H_CHUNK)


def wide_plan(b: int, s: int, k: int, d: int, dc: int, h: int, f: int,
              sms: int, nsplit: int = 0) -> dict:
    """How the wide route tiles a call on a card of ``sms`` SMs, from the
    kernel's own formulas (``wide::make_plan``): whole subsets packed k
    rows apart into 64-row tiles (``spt`` a tile, ``groups`` of them),
    ``nft`` F tiles of ``ft`` columns (layer 1 runs once per F tile), H's
    32-column chunks split ``nsplit`` ways (``cps`` chunks a split) where
    the blocks would leave SMs idle, or as the knob ``nsplit`` says (the
    chunks a split rounded up, so the splits that run may be fewer), and
    x ``resident`` in shared memory where it fits in a block's share of
    an SM (two blocks an SM), else streamed in slices; ``smem`` bytes a
    block."""
    kp = max(k, 1)
    spt, multi = (64 // kp, False) if kp <= 64 else (1, True)
    dp, nchunk = round_up(d, 8), wide_chunks(h)
    nft = -(-f // 256)
    ft = round_up(-(-f // nft), 64)
    groups = -(-(b * s) // spt)
    blocks = groups * nft
    split = 1
    if nsplit > 0:
        split = nsplit
    elif blocks < sms:
        split = min(max(nchunk // 2, 1), -(-sms // blocks))
    cps = -(-nchunk // split)
    split = -(-nchunk // cps)
    w2 = min(4352 // (ft + 4) // 8 * 8, 32) * (ft + 4)

    def smem(xd, dc, resident):
        stage = max(dc * 36 + (0 if resident else 64 * 72), w2)
        main = max(64 * (xd + 40) + 2 * stage, 64 * (ft + 8))
        return 4 * (3 * 64 + 4 + main + (ft if multi else 0))

    size = smem(_stride(dp), 128, True)
    resident = size <= SMEM_SM // WIDE_BLOCKS_PER_SM - 1024
    if not resident:
        size = smem(0, 64, False)
    return dict(resident=int(resident), ft=ft, nft=nft, nsplit=split,
                cps=cps, spt=spt, groups=groups, smem=size)


def gather_mlp_smem(b, s, k, d, dc, h, f, sms: int, rows: int = 0,
                    nsplit: int = 0) -> int:
    """Bytes of shared memory a block of the gather_mlp call takes under
    the knobs (0 = the heuristic's; a forced row tile's even where it
    overflows), as ``gather_mlp_smem_bytes`` answers."""
    way = route(k, d, dc, h, f)
    if way == "linear":
        return linear_plan(b, s, k, f, sms, rows)["smem"]
    if way == "wide":
        return wide_plan(b, s, k, d, dc, h, f, sms, nsplit)["smem"]
    return narrow_smem(narrow_rows(b, s, k, d, dc, h, f, sms, rows), k, d,
                       dc, h, f)


REUSE_LINEAR_MACS = 1 << 28    # rl::kWgmmaMacs
REUSE_LINEAR_MAX_COLS = 128    # its most output columns a block (rl::kMaxN)
REUSE_LINEAR_TAB = 24576       # its bytes for an item's slot table (kTab)


def reuse_linear_wgmma(b: int, hn: int, c: int, d: int, f: int) -> bool:
    """Whether a one-layer resident hub_reuse call takes the wgmma kernel
    (``hub_reuse.cu``: ``linear_wgmma``) rather than the mma.sync one:
    where its products, b·hn islands x min(C, 128) rows x d x f, reach
    2^28 multiply-adds.  On an H100 (700 W) the wgmma kernel took
    dgcnn_c's block 4 at B = 8 (2^29.3) in 0.079 ms against 0.134, and
    lost at every smaller family block, by up to 2x (its W split and
    persistent ring cost ~10 us a call)."""
    return b * hn * min(c, CHUNKS[-1]) * d * f >= REUSE_LINEAR_MACS


def reuse_linear_stage_bytes(rows: int, n: int) -> int:
    """Bytes of a ring stage of the wgmma kernel (``rl::stage_bytes``;
    the linear route's ring, no centers): both W halves (n rows of 16
    fp32 each) and the x slice (row stride 24), rounded up to 1024."""
    return round_up(4 * (2 * n * LINEAR_DEPTH + rows * (LINEAR_DEPTH + 8)),
                    1024)


def _reuse_linear_tail(rows: int) -> int:
    """Bytes after its ring (``rl::tail_bytes``): y's staging (rows x 72
    fp32 and a row of -inf that the dead slots read), the item's slot
    table and liveness (``REUSE_LINEAR_TAB``) and the barriers."""
    return (4 * (rows + 1) * (LINEAR_Y_COLS + 8) + REUSE_LINEAR_TAB
            + 8 * 2 * LINEAR_MAX_STAGES)


def reuse_linear_blocks_per_sm(rows: int, n: int) -> int:
    """Blocks an SM of its ``rows`` x ``n`` tiles (``rl::blocks_per_sm``):
    two of one consumer warpgroup (64 rows), or at n = 64; else one."""
    return 2 if rows <= 64 or n <= LINEAR_TILE_COLS else 1


def reuse_linear_stages(rows: int, n: int) -> int:
    """Its ring stages (``rl::ring_stages``): as many as fit a block's
    budget (a block's limit, or half an SM's less its reserved 1 KB at
    two blocks an SM) after the 1 KB of alignment and the tail, at most
    ``LINEAR_MAX_STAGES``."""
    budget = (SMEM_SM // 2 - 1024
              if reuse_linear_blocks_per_sm(rows, n) == 2 else MAX_SMEM)
    return min(LINEAR_MAX_STAGES,
               (budget - 1024 - _reuse_linear_tail(rows))
               // reuse_linear_stage_bytes(rows, n))


def reuse_linear_widest(f: int) -> int:
    """Its widest output columns a block (``rl::widest``): f in ceil(f /
    128) tiles, each rounded up to 64."""
    nft = -(-f // REUSE_LINEAR_MAX_COLS)
    return round_up(-(-f // nft), LINEAR_TILE_COLS)


def reuse_linear_plan(b: int, hn: int, c: int, d: int, f: int, sms: int,
                      chunk: int = 128) -> dict:
    """How the wgmma kernel (:func:`reuse_linear_wgmma` names its calls)
    tiles the first launch of a call of b·hn islands (``cc`` = min(chunk,
    C) cache rows each) with input width d and f outputs on a card of
    ``sms`` SMs (``hub_reuse.cu``: ``rl::plan``).  The row rule: ``rows``
    = 64 (one consumer warpgroup, ``ipt`` = floor(64 / cc) whole islands
    a tile) where cc <= 64, else 128 (two, one island).  The N rule: the
    widest N (:func:`reuse_linear_widest`), or 64 where ``groups`` x
    ceil(f / N) items would be fewer than 3/4 of the persistent grid's
    blocks (:func:`reuse_linear_blocks_per_sm` an SM).  ``nft`` F tiles
    of ``n`` columns, ``items`` = groups x nft, ``stages`` of the ring, x
    by TMA (``x_tma``, pool 16-byte aligned) where d % 4 == 0 and the
    tile's islands are adjacent rows (one a tile, or cc = C), ``smem``
    bytes a block, ``scratch`` bytes of W's halves (f rounded up to 128
    rows of d rounded up to 16 each, split once a call: every launch's
    nft·n rows lie within it)."""
    islands = b * hn
    cc = min(chunk, c)
    rows = 64 if cc <= 64 else 128
    ipt = rows // cc
    groups = -(-islands // ipt)
    n = reuse_linear_widest(f)
    if n > LINEAR_TILE_COLS and 4 * groups * -(-f // n) < 3 * sms * \
            reuse_linear_blocks_per_sm(rows, n):
        n = LINEAR_TILE_COLS
    nft = -(-f // n)
    stages = reuse_linear_stages(rows, n)
    return dict(rows=rows, ipt=ipt, groups=groups, nft=nft, n=n,
                items=groups * nft, stages=stages,
                x_tma=int(LINEAR_X_TMA and d % 4 == 0
                          and (ipt == 1 or cc == c)),
                smem=(1024 + stages * reuse_linear_stage_bytes(rows, n)
                      + _reuse_linear_tail(rows)),
                scratch=2 * 4 * round_up(f, REUSE_LINEAR_MAX_COLS)
                * round_up(d, LINEAR_DEPTH))


def hub_reuse_launches(c: int, chunk: int = 128) -> list:
    """Cache rows of each resident hub_reuse launch a call of C rows
    makes at ``chunk``."""
    return [min(chunk, c - c0) for c0 in range(0, c, chunk)]


def _resident_smem(rows: int, m: int, k: int, d: int, live: bool,
                   h: int | None = None) -> int:
    """Bytes of shared memory a resident block of ``rows`` cache rows
    takes: the slot table and liveness, x (later y), the h tile (none in
    one layer, h = 0) and the ring."""
    k4 = round_up(k, 4)
    live_floats = (m * k + 15) // 16 * 4 if live else 0
    hs = 64 + 8                             # kHS
    xy = rows * max(_stride(round_up(d, 8)), hs)
    h_tile = 0 if h == 0 else rows * hs
    return 4 * (m * k4 + live_floats + xy + h_tile + 3 * 64 * (64 + 4))


def hub_reuse_route(b: int, hn: int, c: int, m: int, k: int, d: int,
                    f: int, sms: int, h: int | None = None) -> str:
    """The route hub_reuse takes for b clouds of hn islands of C cache
    rows, M subsets of K slots, widths D and F, in the form ``h`` names
    (0: one layer; None or a width: two layers), on a card of ``sms``
    SMs (``hub_reuse.cu``: ``layered_route``): ``"resident"`` where one
    resident launch covers the call (C <= 128 and a block of min(C, 128)
    rows padded to 64 or 128, liveness and the form's h tile counted,
    fits a block's shared memory), or where C passes 128, a 128-row block
    fits and the resident grid, b·hn·ceil(F/64) blocks, is at least 3/4
    of the SMs (PointNet++(c)'s block 2 at C = 256 and B = 8, 128 blocks:
    0.063 ms in two launches against the layered route's 0.080; at B =
    4, 64 blocks, 0.064 against 0.047, on an H100); else ``"layered"``.
    One layer's smaller block keeps 128 rows of D = 259 resident
    (``pointnext_s``'s block 4 at cache_capacity_x = 4)."""
    if c <= CHUNKS[-1]:
        rows = 64 if c <= 64 else 128
        return ("layered" if _resident_smem(rows, m, k, d, True, h)
                > MAX_SMEM else "resident")
    fits = _resident_smem(CHUNKS[-1], m, k, d, True, h) <= MAX_SMEM
    grid = b * hn * -(-f // 64)
    return "resident" if fits and 4 * grid >= 3 * sms else "layered"


def _layered_reason(c: int, m: int, k: int, d: int,
                    h: int | None = None) -> str:
    """Why a layered call is not resident."""
    rows = 64 if c <= 64 else 128
    smem = _resident_smem(rows, m, k, d, True, h)
    if smem > MAX_SMEM:
        return (f"a resident block of {rows} rows takes {smem} B of shared "
                f"memory, past a block's {MAX_SMEM}")
    return (f"C={c} passes {CHUNKS[-1]} cache rows and the resident grid "
            f"would cover less than 3/4 of the card")


def hub_reuse_smem(c: int, m: int, k: int, d: int, live: bool = True,
                   chunk: int = 128, h: int | None = None, *,
                   b: int | None = None, hn: int | None = None,
                   f: int | None = None, sms: int = H100_SMS) -> int:
    """Bytes of shared memory a resident block of the call's largest
    launch (its first chunk's) takes at ``chunk`` in the form ``h`` names
    (0: one layer) (``hub_reuse.cu``: ``smem_bytes``), with the liveness
    mask staged or without, as ``hub_reuse_smem_bytes`` answers; a
    one-layer call whose ``b``, ``hn`` and ``f`` are given and
    :func:`reuse_linear_wgmma` names takes the wgmma kernel's block
    (:func:`reuse_linear_plan` on ``sms`` SMs).  (A layered call's blocks
    take :data:`LAYERED_SMEM`, as ``hub_reuse_plan`` answers.)"""
    if h == 0 and None not in (b, hn, f) and reuse_linear_wgmma(b, hn, c, d,
                                                                 f):
        return reuse_linear_plan(b, hn, c, d, f, sms, chunk)["smem"]
    rows = 64 if min(chunk, c) <= 64 else 128
    return _resident_smem(rows, m, k, d, live, h)


def hub_reuse_chunk(c: int, m: int, k: int, d: int,
                    h: int | None = None) -> int | None:
    """The heuristic's cache rows a resident launch in the form ``h``
    names: 128 where a 128-row block fits (one launch for C <= 128), else
    64 where a 64-row one does, else None (no resident launch fits)."""
    for rows in reversed(CHUNKS):
        block = 64 if min(rows, c) <= 64 else 128
        if _resident_smem(block, m, k, d, True, h) <= MAX_SMEM:
            return rows
    return None


def hub_reuse_layered_plan(b: int, hn: int, c: int, h: int, f: int,
                           sms: int, d: int = 0) -> dict:
    """What a layered call of b clouds of hn islands of C cache rows (H
    hidden, F out) launches on a card of ``sms`` SMs (``hub_reuse.cu``:
    ``layered::plan``): N = b·hn·C rows; layer 1's grid (64-row tiles,
    64-column tiles of H); layer 2's, H split into ``nsplit`` ranges of
    ``kper`` rows (ceil(sms / tiles) where its tiles are fewer than the
    SMs, at most one 64-row stage of H a range); the scratch floats (h,
    then y's partials).  In one layer (h = 0, ``d`` the input width
    given) one GEMM, x·W: ``layer1`` its grid, D split as H is in two,
    ``layer2`` None, the scratch y's partials alone."""
    if h == 0 and d < 1:
        raise ValueError("hub_reuse_layered_plan: one layer (h = 0) needs "
                         "the input width d")
    n = b * hn * c
    t = LAYERED_TILE
    rt, ft = -(-n // t), -(-f // t)
    tiles = rt * ft
    nch = -(-(h or d) // 64)
    want = 1 if tiles >= sms else -(-sms // tiles)
    per = -(-nch // min(want, nch))
    nsplit = -(-nch // per)
    if h == 0:
        return dict(n=n, layer1=(rt, ft, nsplit), layer2=None,
                    nsplit=nsplit, kper=per * 64, scratch=nsplit * n * f)
    return dict(n=n, layer1=(rt, -(-h // t), 1), layer2=(rt, ft, nsplit),
                nsplit=nsplit, kper=per * 64,
                scratch=n * h + nsplit * n * f)


def knobs_of(kernel: str, dims: dict, sms: int = H100_SMS) -> tuple:
    """The knobs that act on the call ``dims`` describes: ``("rows",)``
    on gather_mlp's narrow and linear routes, ``("nsplit",)`` on its wide
    one, ``("chunk",)`` on hub_reuse's resident route (either form), none
    on its layered one (on a card of ``sms`` SMs, an H100's by
    default)."""
    if kernel == "hub_reuse":
        way = hub_reuse_route(*(dims[n] for n in ("b", "hn", "c", "m", "k",
                                                  "d", "f")), sms,
                              h=dims.get("h"))
        return ("chunk",) if way == "resident" else ()
    way = route(dims["k"], dims["d"], dims["dc"], dims["h"], dims["f"])
    return ("nsplit",) if way == "wide" else ("rows",)


def infeasible(kernel: str, dims: dict, knobs: dict,
               sms: int = H100_SMS) -> str | None:
    """Why the knobs of a plan do not fit the call ``dims`` describes
    on a card of ``sms`` SMs (None where they do).  ``knobs`` holds the
    plan's knob fields only (empty = the heuristic's launch); a knob of
    another route does not fit."""
    if kernel not in KNOBS:
        return f"unknown kernel {kernel!r}"
    for name, v in knobs.items():
        if name not in KNOBS[kernel]:
            return f"{name!r} is not a knob of {kernel}"
        if not isinstance(v, int) or isinstance(v, bool):
            return f"{name!r} must be an int, got {v!r}"
        if name not in knobs_of(kernel, dims, sms):
            why = ""
            if kernel == "hub_reuse":
                why = _layered_reason(*(dims[n] for n in "cmkd"),
                                      dims.get("h"))
                why = f" ({why})"
            return (f"{name!r} acts on {kernel}'s "
                    f"{' and '.join(KNOB_ROUTES[name])} route and this "
                    f"call takes another one{why}")
        if name == "rows":
            if v not in ROWS:
                return f"'rows' must be one of {ROWS}, got {v}"
            if dims["h"] == 0:               # linear: any D fits
                continue
            smem = narrow_smem(v, dims["k"], dims["d"], dims["dc"],
                               dims["h"], dims["f"])
            if smem > MAX_SMEM:
                return (f"a {v}-row tile takes {smem} B of shared memory, "
                        f"past a block's {MAX_SMEM}")
        elif name == "nsplit":
            most = wide_chunks(dims["h"])
            if not 1 <= v <= most:
                return f"'nsplit' must lie in 1..{most} (H/32), got {v}"
        elif name == "chunk":
            if v not in CHUNKS:
                return f"'chunk' must be one of {CHUNKS}, got {v}"
    if kernel == "hub_reuse" and knobs_of(kernel, dims, sms):
        c, m, k, d, h = (dims.get(n) for n in ("c", "m", "k", "d", "h"))
        smem = hub_reuse_smem(c, m, k, d, True,
                              knobs.get("chunk",
                                        hub_reuse_chunk(c, m, k, d, h)), h,
                              b=dims["b"], hn=dims["hn"], f=dims["f"],
                              sms=sms)
        if smem > MAX_SMEM:
            return (f"a launch takes {smem} B of shared memory, past a "
                    f"block's {MAX_SMEM}")
    return None


def feasible(kernel: str, dims: dict, knobs: dict,
             sms: int = H100_SMS) -> bool:
    """Whether the knobs fit the call (see :func:`infeasible`)."""
    return infeasible(kernel, dims, knobs, sms) is None
