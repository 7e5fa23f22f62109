"""hub_reuse's one-layer kernel on 3xTF32 ``wgmma`` (``rl::`` in
``csrc/hub_reuse.cu``), which a one-layer resident call takes where its
products reach 2^28 multiply-adds (``tiling.reuse_linear_wgmma``; the
mma.sync kernel takes the rest): W split once a call into TF32 halves in
scratch (the split gather_mlp's linear route takes,
``kernels.tf32_split``), then a persistent kernel over items, each a row
tile of whole islands by N output columns, with the reuse gather fused
into its epilogue.

On the CPU: the rule that picks the kernel, and the planner's formulas
(rows, islands a tile, groups, F tiles, N, items, stages, x by TMA,
shared memory, scratch) at every block of chip_smoke.py's
``REUSE_LINEAR`` against hand-worked values;
the tile packing emulated in PyTorch (islands packed Cc rows apart, a
slot clamped inside its own island, the chunk offset, launches merged
by a max) against ``hub_reuse_ref``, and a packing that clamps across
islands shown to break it; the 3xTF32 arithmetic in the halves' k order
and the kernels' product order, k8 step by k8 step; the shared split's
plain version.  On a CUDA host (``pytest -m cuda``) the kernel and its
split against their plain versions at packing edges."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import tiling
from repro_torch.kernels.hub_reuse import hub_reuse, hub_reuse_ref
from repro_torch.kernels.hub_reuse import ops as hub_ops
from repro_torch.kernels.tf32_split import k_order, split_weights_ref, tf32

torch.set_num_threads(1)

BIG = 3.4e38
SMS = 132
# chip_smoke.py's REUSE_LINEAR: (b, hn, c, m, k, d, f) of every one-layer
# family call at the families' batches, and pointvector_l's block 4 under
# cache_capacity_x = 4 (C = 128)
REUSE_LINEAR = {
    "dgcnn_c_blk1": (8, 32, 40, 64, 20, 6, 64),
    "dgcnn_c_blk2": (8, 32, 40, 64, 20, 128, 64),
    "dgcnn_c_blk3": (8, 32, 40, 64, 20, 128, 128),
    "dgcnn_c_blk4": (8, 32, 40, 64, 20, 256, 256),
    "dgcnn_s_blk1": (1, 256, 40, 64, 20, 12, 64),
    "dgcnn_s_blk2": (1, 256, 40, 64, 20, 128, 64),
    "pointnext_s_blk1": (2, 64, 64, 64, 32, 35, 64),
    "pointnext_s_blk2": (2, 16, 64, 64, 32, 67, 128),
    "pointnext_s_blk3": (2, 4, 64, 64, 32, 131, 256),
    "pointnext_s_blk4": (2, 1, 64, 64, 32, 259, 512),
    "pointvector_l_blk1": (2, 64, 64, 64, 32, 67, 96),
    "pointvector_l_blk2": (2, 16, 64, 64, 32, 99, 192),
    "pointvector_l_blk3": (2, 4, 64, 64, 32, 195, 384),
    "pointvector_l_blk4": (2, 1, 64, 64, 32, 387, 768),
    "pointvector_l_blk4_c128": (2, 1, 128, 64, 32, 387, 768)}
PLAN_KEYS = ("rows", "ipt", "groups", "nft", "n", "items", "stages",
             "x_tma", "smem", "scratch")
# worked by hand on 132 SMs (see _worked): rows, islands a tile, groups,
# F tiles, N, items, stages, x by TMA, shared memory, scratch bytes
WORKED = {
    "dgcnn_c_blk1": (64, 1, 256, 1, 64, 256, 4, 0, 101792, 16384),
    "dgcnn_c_blk2": (64, 1, 256, 1, 64, 256, 4, 1, 101792, 131072),
    "dgcnn_c_blk3": (64, 1, 256, 1, 128, 256, 3, 1, 112032, 131072),
    "dgcnn_c_blk4": (64, 1, 256, 2, 128, 512, 3, 1, 112032, 524288),
    "dgcnn_s_blk1": (64, 1, 256, 1, 64, 256, 4, 1, 101792, 16384),
    "dgcnn_s_blk2": (64, 1, 256, 1, 64, 256, 4, 1, 101792, 131072),
    "pointnext_s_blk1": (64, 1, 128, 1, 64, 128, 4, 0, 101792, 49152),
    "pointnext_s_blk2": (64, 1, 32, 2, 64, 64, 4, 0, 101792, 81920),
    "pointnext_s_blk3": (64, 1, 8, 4, 64, 32, 4, 0, 101792, 294912),
    "pointnext_s_blk4": (64, 1, 2, 8, 64, 16, 4, 0, 101792, 1114112),
    "pointvector_l_blk1": (64, 1, 128, 2, 64, 256, 4, 0, 101792, 81920),
    "pointvector_l_blk2": (64, 1, 32, 3, 64, 96, 4, 0, 101792, 229376),
    "pointvector_l_blk3": (64, 1, 8, 6, 64, 48, 4, 0, 101792, 638976),
    "pointvector_l_blk4": (64, 1, 2, 12, 64, 24, 4, 0, 101792, 2457600),
    "pointvector_l_blk4_c128": (128, 1, 2, 12, 64, 24, 2, 0, 103840,
                                2457600)}
# the blocks whose products reach 2^28 multiply-adds: dgcnn_c's block 4
# at B = 8 (256 x 40 x 256 x 256 = 2^29.3); block 3 is 2^27.3
WGMMA_BLOCKS = ("dgcnn_c_blk4",)


def _worked(rows, n, d, f):
    """The kernel's shared memory and scratch by hand: a ring stage is W's
    two halves (n rows of 16 floats) and the x slice (rows x 24 floats),
    rounded up to 1 KB; the tail y's staging (rows x 72 floats and a row
    of -inf), 24 KB for an item's slot table and 16 barriers of 8 bytes;
    as many stages as the budget holds after 1 KB of alignment (a block's
    232,448 B, or 115,712 at two blocks an SM: 64 rows, or n = 64), at
    most 8.  Scratch: W's halves at f rounded up to 128 rows of d rounded
    up to 16."""
    stage = -(-4 * (2 * n * 16 + rows * 24) // 1024) * 1024
    tail = 4 * (rows + 1) * 72 + 24576 + 8 * 16
    two = rows == 64 or n == 64
    budget = 233472 // 2 - 1024 if two else 232448
    stages = min(8, (budget - 1024 - tail) // stage)
    return (stages, 1024 + stages * stage + tail,
            2 * 4 * -(-f // 128) * 128 * -(-d // 16) * 16)


@pytest.mark.parametrize("blk", sorted(REUSE_LINEAR))
def test_plan_at_every_reuse_linear_block(blk):
    """tiling.reuse_linear_plan at each REUSE_LINEAR block on 132 SMs
    equals the hand-worked row: the row rule (64 rows where C <= 64, else
    128), whole islands a tile, the N rule (F in tiles of at most 128,
    64 where the items leave a quarter of the grid idle), stages, shared
    memory and scratch by :func:`_worked`; the wrapper's plan agrees; the
    wgmma kernel takes only dgcnn_c's block 4, and the smem the planner
    reports for the call is that kernel's there, the mma.sync block's
    elsewhere."""
    b, hn, c, m, k, d, f = REUSE_LINEAR[blk]
    got = tiling.reuse_linear_plan(b, hn, c, d, f, SMS)
    want = dict(zip(PLAN_KEYS, WORKED[blk]))
    assert got == want, (got, want)
    rows, n = want["rows"], want["n"]
    assert _worked(rows, n, d, f) == (want["stages"], want["smem"],
                                      want["scratch"])
    assert want["ipt"] == rows // c and want["ipt"] * c <= rows
    assert want["groups"] == -(-(b * hn) // want["ipt"])
    assert (want["nft"] - 1) * n < f <= want["nft"] * n
    assert want["items"] == want["groups"] * want["nft"]
    assert want["smem"] <= tiling.MAX_SMEM
    assert hub_ops.linear_plan(b, hn, c, d, f, "cpu") == got
    wgmma = tiling.reuse_linear_wgmma(b, hn, c, d, f)
    assert wgmma == (blk in WGMMA_BLOCKS)
    assert (b * hn * min(c, 128) * d * f >= 2 ** 28) == wgmma
    assert tiling.hub_reuse_smem(c, m, k, d, h=0, b=b, hn=hn, f=f) == (
        want["smem"] if wgmma else tiling.hub_reuse_smem(c, m, k, d, h=0))


@pytest.mark.parametrize("islands,c,f,want", [
    # one island of 40 rows a 64-row tile, F in two tiles of 128
    (2048, 40, 256, dict(rows=64, ipt=1, groups=2048, n=128, nft=2)),
    # three islands of 20 a 64-row tile
    (1024, 20, 256, dict(rows=64, ipt=3, groups=342, n=128)),
    # C = 1: 64 islands a 64-row tile
    (64 * 128, 1, 64, dict(rows=64, ipt=64, groups=128, n=64)),
    # C past 64: 128 rows, one island; N = 128 on a full grid
    (512, 100, 77, dict(rows=128, ipt=1, groups=512, n=128, nft=1)),
    # a small grid: N down to 64
    (4, 64, 512, dict(rows=64, ipt=1, groups=4, n=64, nft=8)),
    (32, 128, 256, dict(rows=128, ipt=1, groups=32, n=64, nft=4)),
    # F = 130: two tiles of 128 (the second 2 columns wide)
    (1024, 50, 130, dict(rows=64, ipt=1, groups=1024, n=128, nft=2))])
def test_row_and_n_rules_by_hand(islands, c, f, want):
    """The row and N rules at shapes off the families: one island a
    64-row tile, several where they fit, 64 islands of C = 1, C > 64 in
    128 rows, N down to 64 on a small grid at both row tiles, an odd
    F."""
    got = tiling.reuse_linear_plan(1, islands, c, 64, f, SMS)
    assert {key: got[key] for key in want} == want, got


def _slot_rows(slot, live, j, c, c0, cc):
    """The tile row each slot reads (-1: none): the kernel's slot_row."""
    ok = slot >= 0
    if live is not None:
        ok &= live
    r = torch.where(ok, torch.clamp(slot, max=c - 1) - c0, -1)
    return torch.where((r >= 0) & (r < cc), j * cc + r, -1)


def _emulate(pool, slot, comp, w, b, live, chunk, rows, n,
             cross_island=False):
    """The wgmma route's tiling in PyTorch (float64 products): each launch
    of ``cc`` = min(chunk, C − c0) rows a island, tiles of ``rows`` rows
    holding floor(rows / cc) islands packed cc rows apart (zero past
    them), F tiles of n columns; y = tile·W; each subset's live slots
    clamped at C − 1, counted inside [c0, c0 + cc) of their own island,
    read from the tile; max, + b, + comp, -BIG where none; each launch
    max-merged into the last.  ``cross_island``: a wrong packing that
    clamps a slot at the tile's last row, past its own island."""
    bsz, hn, c, d = pool.shape
    m, k = slot.shape[-2:]
    f = w.shape[1]
    isl = bsz * hn
    x = pool.reshape(isl, c, d).double()
    sl, cp = slot.reshape(isl, m, k), comp.reshape(isl, m, f).double()
    lv = None if live is None else live.reshape(isl, m, k)
    out = torch.full((isl, m, f), -BIG, dtype=torch.float64)
    for c0 in range(0, c, chunk):
        cc = min(chunk, c - c0)
        ipt = rows // cc
        step = torch.empty((isl, m, f), dtype=torch.float64)
        for i0 in range(0, isl, ipt):
            tile = torch.zeros((rows, d), dtype=torch.float64)
            nisl = min(ipt, isl - i0)
            for j in range(nisl):
                tile[j * cc:(j + 1) * cc] = x[i0 + j, c0:c0 + cc]
            for f0 in range(0, f, n):
                y = tile @ w[:, f0:f0 + n].double()
                for j in range(nisl):
                    s, live_j = sl[i0 + j], None if lv is None else lv[i0 + j]
                    r = _slot_rows(s, live_j, j, c, c0, cc)
                    if cross_island:
                        ok = s >= 0 if live_j is None else (s >= 0) & live_j
                        r = torch.where(ok, torch.clamp(
                            j * cc + s - c0, max=nisl * cc - 1), -1)
                    g = y[r.clamp(min=0)]                       # (m, k, n)
                    g = torch.where((r >= 0)[..., None], g, -torch.inf)
                    best = g.amax(1)
                    val = best + b[f0:f0 + n].double() + cp[i0 + j, :,
                                                            f0:f0 + n]
                    step[i0 + j, :, f0:f0 + n] = torch.where(
                        best == -torch.inf, -BIG, val)
        out = step if c0 == 0 else torch.maximum(out, step)
    return out.reshape(bsz, hn, m, f)


# (b, hn, c, m, k, d, f, chunk, rows, n), as the kernel tiles them: 3
# islands of 20 a 64-row tile; C = 1 (64 islands a tile); C = 80 in
# launches of 64 and 16 rows merged (one island a tile, then four); F =
# 77 off a multiple of 64; K = 40 past a warp's 32 slots; N = 64 below F
PACKINGS = [(2, 4, 20, 6, 5, 9, 64, 128, 64, 64),
            (1, 300, 1, 3, 4, 7, 70, 128, 64, 64),
            (2, 3, 80, 5, 13, 11, 77, 64, 64, 128),
            (1, 7, 50, 4, 40, 8, 130, 128, 64, 128),
            (2, 2, 64, 4, 6, 10, 200, 128, 64, 64)]


@pytest.mark.parametrize("shape", PACKINGS)
def test_packing_emulated_matches_plain(shape):
    """The route's packing emulated (:func:`_emulate`) equals
    ``hub_reuse_ref`` within 1e-9 of fp64, with liveness and without,
    the -BIG identity exact (subsets with no cached slot, slots past C
    clamped at C − 1); a packing that clamps a slot into the next packed
    island breaks it."""
    b, hn, c, m, k, d, f, chunk, rows, n = shape
    rng = np.random.default_rng(c * f + k)
    pool = torch.from_numpy(rng.standard_normal((b, hn, c, d)))
    comp = torch.from_numpy(rng.standard_normal((b, hn, m, f)))
    w = torch.from_numpy(rng.standard_normal((d, f)) * (2 / d) ** .5)
    bias = torch.from_numpy(rng.standard_normal(f) * .1)
    slot = torch.from_numpy(rng.integers(-1, c + 3, (b, hn, m, k))
                            .astype(np.int32))
    slot[:, :, 0] = -1                              # no cached slot
    live = torch.from_numpy(rng.uniform(size=(b, hn, m, k)) < 0.8)
    for lv in (live, None):
        want = hub_reuse_ref(pool, slot, comp, w, bias, live=lv)
        got = _emulate(pool, slot, comp, w, bias, lv, chunk, rows, n)
        dead = want <= -BIG / 2
        assert torch.equal(got <= -BIG / 2, dead)
        assert bool((got[dead] == -BIG).all())
        assert (got[~dead] - want[~dead]).abs().max().item() <= 1e-9
    if c > 1 and rows // min(chunk, c) > 1:
        bad = _emulate(pool, slot, comp, w, bias, live, chunk, rows, n,
                       cross_island=True)
        assert not torch.allclose(bad, hub_reuse_ref(pool, slot, comp, w,
                                                     bias, live=live))


# (C, D, F): dgcnn_c block 4's widths, pointvector_l block 4's (D = 387,
# F in tiles), DGCNN block 1's D = 6
TF32_BLOCKS = {"dgcnn_c_blk4": (40, 256, 256),
               "pointvector_l_blk4": (64, 387, 768),
               "dgcnn_c_blk1": (40, 6, 64)}


@pytest.mark.parametrize("blk", sorted(TF32_BLOCKS))
def test_tf32x3_in_the_kernels_order_keeps_the_tolerance(blk):
    """The route's arithmetic as the kernel orders it: W through its split
    (``split_weights_ref``: K-major, k permuted within 8-groups), x padded
    to D_pad and read in the A fragment's k order, split big / small; per
    k8 step the three products in the kernel's order (small·big,
    big·small, big·big) added to an fp32 accumulator; the gather, + b, +
    comp.  Within 1e-4 · max(1, |ref|) of fp64 (1e-5 in fact); one TF32
    pass (big·big only) breaks the 1e-4 limit the kernel is held to."""
    c, d, f = TF32_BLOCKS[blk]
    m, k = 64, 20
    rng = np.random.default_rng(d + f)
    r = lambda *shape, scale=1.0: torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32))
    pool, comp = r(1, c, d), r(1, m, f)
    w, bias = r(d, f, scale=(2 / d) ** .5), r(f, scale=.1)
    slot = torch.from_numpy(rng.integers(-1, c, (1, m, k)).astype(np.int32))
    ref = hub_reuse_ref(pool.double(), slot, comp.double(), w.double(),
                        bias.double())
    live = ref > -BIG / 2
    lim = max(1.0, ref[live].abs().max().item())
    f_pad = -(-f // 128) * 128
    big_w, small_w = split_weights_ref(w, f_pad)           # (f_pad, D_pad)
    d_pad = big_w.shape[1]
    x = torch.nn.functional.pad(pool[0], (0, d_pad - d))[:, k_order(d_pad)]
    xb = tf32(x)
    xs = tf32(x - xb)
    err = {}
    for passes in (1, 3):
        acc = torch.zeros((c, f_pad), dtype=torch.float32)
        for s in range(0, d_pad, 8):
            kk = slice(s, s + 8)
            if passes == 3:
                acc = acc + xs[:, kk] @ big_w[:, kk].t()
                acc = acc + xb[:, kk] @ small_w[:, kk].t()
            acc = acc + xb[:, kk] @ big_w[:, kk].t()
        # the gather on y = acc: hub_reuse_ref with acc as its pool, W = I
        got = hub_reuse_ref(acc[None, :, :f], slot, comp, torch.eye(f),
                            bias)
        assert torch.equal(got > -BIG / 2, live)
        err[passes] = (got[live].double() - ref[live]).abs().max().item()
    assert err[3] <= 1e-5 * lim, err
    assert err[1] > 1e-4 * lim, err


@pytest.mark.parametrize("d,f", [(256, 256), (387, 768), (6, 64),
                                 (131, 77), (35, 100)])
def test_split_plain_version_is_shared(d, f):
    """One plain version of the split (``kernels.tf32_split``) serves both
    kernels: at gather_mlp's F_pad it is gather_mlp's own split bit for
    bit; at hub_reuse's (F rounded up to 128) the halves are TF32 (low 13
    bits 0), K-major in the permuted k order, big = rna(W), zero past D
    and F; the wrapper on a CPU tensor returns that plain version."""
    from repro_torch.kernels.gather_mlp.ref import \
        split_weights_ref as gather_split
    rng = np.random.default_rng(d * f)
    w = torch.from_numpy((rng.standard_normal((d, f)) * (2 / d) ** .5)
                         .astype(np.float32))
    nft, n = tiling.linear_tiles(f)
    assert torch.equal(split_weights_ref(w, nft * n), gather_split(w))
    f_pad = -(-f // 128) * 128
    halves = split_weights_ref(w, f_pad)
    d_pad = -(-d // 16) * 16
    assert halves.shape == (2, f_pad, d_pad)
    bits = halves.view(torch.int32)
    assert not bool((bits & 0x1FFF).any())
    pos = 8 * (torch.arange(d) // 8) + (torch.arange(d) % 2) * 4 \
        + (torch.arange(d) % 8) // 2
    assert torch.equal(halves[0][:f][:, pos], tf32(w).t())
    assert torch.equal(halves[1][:f][:, pos], tf32(w - tf32(w)).t())
    assert not bool(halves[:, f:].any())
    assert torch.equal(hub_ops.split_weights(w), halves)


def test_wgmma_rule():
    """The kernel rule: the wgmma kernel where b·hn·min(C, 128)·d·f
    reaches 2^28 (C past 128 counts as the 128 rows a launch takes), the
    mma.sync kernel below it; the route rule is the kernels' common one
    (pointvector_l's block 4 at C = 128 and D = 387 stays layered: 128
    rows of it pass a resident block's shared memory, and its layered
    call took 0.035 ms against the wgmma kernel's 0.060 on an H100)."""
    assert tiling.reuse_linear_wgmma(1, 1024, 64, 64, 64)
    assert not tiling.reuse_linear_wgmma(1, 1024, 64, 64, 63)
    assert tiling.reuse_linear_wgmma(1, 512, 200, 64, 64)
    assert not tiling.reuse_linear_wgmma(1, 511, 200, 64, 64)
    assert tiling.REUSE_LINEAR_MACS == 2 ** 28
    assert tiling.hub_reuse_route(2, 1, 128, 64, 32, 387, 768, SMS, h=0) \
        == "layered"
    assert tiling.hub_reuse_route(8, 32, 40, 64, 20, 256, 256, SMS, h=0) \
        == "resident"
    # the smem the planner reports: the mma.sync block without b, hn, f
    assert tiling.hub_reuse_smem(40, 64, 20, 256, h=0) != \
        tiling.hub_reuse_smem(40, 64, 20, 256, h=0, b=8, hn=32, f=256)


# on the card: (B, H, C, M, K, D, F, chunk), each on the wgmma kernel:
# C = 1 (64 islands a tile), 3 islands of 20 a tile, C = 100 in chunks
# of 64 (two launches merged, one W split), F = 77 and 130, K = 41 with
# M·K odd, D = 512 (a deep ring), D = 131 (x by cp.async), and each of
# the four instantiations (64 or 128 rows by N = 64 or 128)
CARD_PACKINGS = ((1, 8192, 1, 3, 4, 256, 128, 128),
                 (4, 512, 20, 16, 8, 128, 256, 128),
                 (2, 512, 100, 5, 13, 131, 77, 64),
                 (3, 512, 50, 7, 41, 33, 130, 128),
                 (2, 64, 64, 3, 5, 512, 256, 128),
                 (2, 64, 128, 64, 32, 256, 256, 128),
                 (2, 16, 128, 8, 8, 256, 256, 128),
                 (1, 64, 64, 8, 8, 256, 256, 128))


@pytest.mark.cuda
def test_wgmma_route_matches_plain_version_on_card():
    """On a CUDA host, at the packing's edges: the wgmma kernel against
    the plain version within 1e-4 · max(1, max|plain|) (the -BIG identity
    exactly), live given and not, repeats bit-equal; a
    ``hub_reuse_linear_wgmma`` launch a chunk after one
    ``hub_reuse_split_weights`` a call; the library's plan equal to
    tiling.py's (x_tma where pool is aligned); its split equal to
    ``split_weights_ref`` bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import LAUNCHES
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator().manual_seed(0)
    r = lambda *s, scale=1.0: (torch.randn(s, generator=g) * scale).to(dev)
    names = ("hub_reuse_linear_wgmma", "hub_reuse_split_weights")
    for b, hn, c, m, k, d, f, chunk in CARD_PACKINGS:
        assert tiling.reuse_linear_wgmma(b, hn, c, d, f)
        lp = tiling.reuse_linear_plan(b, hn, c, d, f, sms, chunk)
        assert hub_ops.library_linear_plan(b, hn, c, m, k, d, f, chunk) \
            == lp
        pool, comp = r(b, hn, c, d), r(b, hn, m, f)
        w, bias = r(d, f, scale=(2 / d) ** .5), r(f, scale=.1)
        slot = torch.randint(-1, c + 2, (b, hn, m, k), generator=g,
                             dtype=torch.int32).to(dev)
        live = (torch.rand(b, hn, m, k, generator=g) < .8).to(dev)
        assert torch.equal(hub_ops.split_weights(w),
                           split_weights_ref(w.cpu(), -(-f // 128) * 128)
                           .to(dev))
        launches = len(tiling.hub_reuse_launches(c, chunk))
        for lv in (live, None):
            want = hub_reuse_ref(pool, slot, comp, w, bias, live=lv)
            before = [LAUNCHES[n] for n in names]
            got = hub_reuse(pool, slot, comp, w, bias, live=lv, chunk=chunk)
            torch.cuda.synchronize()
            assert [LAUNCHES[n] for n in names] == [before[0] + launches,
                                                    before[1] + 1]
            dead = want <= -BIG / 2
            assert torch.equal(got[dead], want[dead])
            lim = 1e-4 * max(1.0, want[~dead].abs().max().item())
            assert (got[~dead] - want[~dead]).abs().max().item() <= lim
            assert torch.equal(hub_reuse(pool, slot, comp, w, bias,
                                         live=lv, chunk=chunk), got)
