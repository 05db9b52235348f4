"""Kernel B1v: the blend-forward ablations of the variant benchmark.

Replaces the six Pallas kernels of ``scripts/bench_blend_variants.py``
(``make_fwd_kernel(mode)`` and ``make_pair_kernel()``), copies of kernel B1
that differ inside one chunk of 128 slots of a tile's depth-sorted list:

- ``base``: B1's math, ``T_excl = T_carry · exp(cumsum_excl(log1p(−α)))``;
- ``empty``: only the init (image 0, T 1, done 0) of every tile;
- ``notrans``: ``exp(−σ)`` → ``1/(1+σ)`` and ``log1p(−α)`` → ``−α`` (wrong on
  purpose; the cumulation keeps its ``exp``);
- ``nomatmul``: ``T_excl = T_carry`` for every slot of a chunk and
  ``T_new = min(T_after)`` over the composited slots (wrong on purpose);
- ``scan``: the exclusive cumulative product of ``1 − α`` (exact);
- ``pair``: two chunks of the global chunk order per step, both composited
  into the tile that owns the first, each with its own tile's pixels and
  gaussians, the tile initialised only where its first pair starts at slot 0.

Per pixel, T and the done flag carry from chunk to chunk; a chunk's slots
past the tile's count are masked. The output is the script's block layout,
(num_tiles, 256, 16) float32: columns [0, C) the image, 7 the transmittance,
8 the done flag, the rest 0, pixels row-major in each 16×16 tile.

``pair`` depends on the global order of chunks, which is the JAX package's
aligned layout (``gaussctrl_exp_tpu/ops/binning.py:227-249``): each tile's
list rounded up to whole chunks, tiles in groups of 8 whose chunk counts are
padded to a multiple of 4, at the script's capacity. The port's binning sizes
its list exactly, so ``chunk_table`` rebuilds that layout from the tile
counts. A tile the TPU kernel never initialises holds undefined values there;
the port writes the init into it, and ``defined_tiles`` names the tiles where
the two are comparable.

``blend_variant_plain`` is the plain PyTorch version (all owners' chunks
batched, one (256, 128) block per chunk, as the TPU kernel works). Kernel B1v
evaluates only the pairs whose gaussian's footprint box (``ops/blend.py``,
at the mode's own skip level) meets the pixel's warp, which changes no bit
(no pair outside its box passes the alpha test); ``variant_pairs`` counts
the pairs it evaluates for its bound;
``blend_variant`` launches kernel B1v (``csrc/blend_variants.cu``) on CUDA
tensors or raises, and takes the plain version on CPU tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import blend_cuda, cuda_build
from .binning import TileBins
from .blend import ALPHA_CLAMP, MIN_ALPHA, T_EPS, _gather, _pixel_grid, footprint_box, warp_meets
from .projection import BLOCK

MODES = ("base", "empty", "notrans", "nomatmul", "scan", "pair")
CHUNK = 128  # slots per chunk (blend_pallas.CHUNK, binning.ALIGN)
GROUP = 8  # tiles per group of the aligned layout (binning.GROUP)
SUPER = 4  # a group's chunk count is padded to a multiple of this (binning.SUPER)
P = BLOCK * BLOCK  # pixels per tile
NCOL = 16  # columns of a pixel's row in the block layout
COL_T, COL_DONE = 7, 8
CAPACITY = 1 << 18  # the variant script's intersection capacity (CAP)
# a pixel is "in the band" when a live slot's T_after lies within this
# relative distance of T_EPS: two implementations that round the
# transmittance differently (by ~1e-6 relative) may take different stop
# decisions there; about one stopping pixel in a thousand lies in it
STOP_BAND = 1e-4
_BATCH_OWNERS = 64  # owners per batch of the plain version: 64 × 256 × 128 floats per intermediate

_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 13 + [ctypes.c_int] * 3 + [ctypes.c_void_p]

launches = dict.fromkeys(MODES, 0)  # B1v launches per mode since the caller last set them to 0


@dataclasses.dataclass
class ChunkTable:
    """The JAX package's per-chunk metadata of the aligned stream."""

    chunk_tile: torch.Tensor  # (nc,) int32 tile owning each chunk (non-decreasing)
    chunk_base: torch.Tensor  # (nc,) int32 within-tile offset of the chunk's first slot
    chunk_cnt: torch.Tensor  # (nc,) int32 the owning tile's intersection count
    num_tiles: int
    aligned_capacity: int


@dataclasses.dataclass
class VariantRun:
    """The plain version's output, with what a bound and a comparison need."""

    out: torch.Tensor  # (num_tiles, 256, 16) float32 block layout
    band: torch.Tensor  # (num_tiles, 256) bool: a stop decision within STOP_BAND of T_EPS
    chunks: int  # chunks evaluated (chunks of tiles whose pixels had all stopped are skipped)
    pairs: int  # (pixel, gaussian) pairs walked: 256 per slot of those chunks in the list
    composited: int  # of those, the pairs composited
    # (num_tiles, 256) int64: the index, in its owner tile's chunks
    # (``_sequences``), of the chunk at whose end each pixel became done;
    # NEVER_DONE where it did not
    stop_chunk: torch.Tensor


NEVER_DONE = 1 << 40


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown blend variant {mode!r}; expected one of {MODES}")


def aligned_capacity(capacity: int, num_tiles: int) -> int:
    """Slots of the aligned stream for ``capacity`` intersections: every tile
    padded by up to a chunk, every group by up to SUPER − 1 chunks, rounded
    to SUPER chunks (``binning.py:327-331``)."""
    n_groups = (num_tiles + GROUP - 1) // GROUP
    cap = capacity + num_tiles * CHUNK + n_groups * (SUPER - 1) * CHUNK
    q = SUPER * CHUNK
    return (cap + q - 1) // q * q


def chunk_table(tile_cnt: torch.Tensor, tiles_x: int, tiles_y: int, aligned_cap: int) -> ChunkTable:
    """Owner, base and count of each chunk of the aligned stream, as
    ``binning.py:230-249`` lays it out: per-tile starts rounded up to chunks,
    each group of GROUP tiles padded to a multiple of SUPER chunks; chunks
    past the last tile keep the last marked tile."""
    num_tiles = tiles_x * tiles_y
    dev = tile_cnt.device
    cnt = tile_cnt.long()
    n_groups = (num_tiles + GROUP - 1) // GROUP
    chunks_t = (cnt + CHUNK - 1) // CHUNK
    gch = torch.nn.functional.pad(chunks_t, (0, n_groups * GROUP - num_tiles)).reshape(n_groups, GROUP)
    group_chunks = gch.sum(1)
    group_padded = (group_chunks + SUPER - 1) // SUPER * SUPER
    group_start = torch.cumsum(group_padded, 0) - group_padded
    within = torch.cumsum(gch, 1) - gch
    aligned_start = (group_start[:, None] + within).reshape(-1)[:num_tiles] * CHUNK
    nc = aligned_cap // CHUNK
    tids = torch.arange(num_tiles, device=dev)
    first = aligned_start // CHUNK
    keep = first < nc  # starts past the capacity are dropped, as the scatter does
    marks = torch.zeros(nc, dtype=torch.long, device=dev)
    marks.scatter_reduce_(0, first[keep], tids[keep], reduce="amax")
    owner = torch.cummax(marks, 0).values
    base = torch.arange(nc, device=dev) * CHUNK - aligned_start[owner]
    i32 = torch.int32
    return ChunkTable(owner.to(i32), base.to(i32), cnt[owner].to(i32), num_tiles, aligned_cap)


def bins_chunk_table(bins: TileBins, img_height: int, img_width: int, capacity: int = CAPACITY) -> ChunkTable:
    """``chunk_table`` of ``bins`` at ``capacity`` intersections; raises if
    the list is longer, where the JAX binning would drop intersections."""
    if bins.n_isects > capacity:
        raise ValueError(f"{bins.n_isects} intersections exceed the capacity {capacity}")
    tiles_x = (img_width + BLOCK - 1) // BLOCK
    tiles_y = (img_height + BLOCK - 1) // BLOCK
    return chunk_table(bins.tile_cnt, tiles_x, tiles_y, aligned_capacity(capacity, tiles_x * tiles_y))


def _pair_ranges(table: ChunkTable) -> tuple[torch.Tensor, torch.Tensor]:
    """Per tile, the steps [lo, hi) of ``pair`` whose first chunk it owns."""
    first = table.chunk_tile[0::2].contiguous()
    tids = torch.arange(table.num_tiles, device=first.device, dtype=first.dtype)
    lo = torch.searchsorted(first, tids, side="left").to(torch.int32)
    hi = torch.searchsorted(first, tids, side="right").to(torch.int32)
    return lo, hi


def defined_tiles(mode: str, table: ChunkTable) -> torch.Tensor:
    """(num_tiles,) bool: the tiles whose block the TPU kernel initialises,
    so that its output there is defined. Every mode initialises a tile at a
    step whose (first) chunk it owns at base 0; elsewhere the port's output is
    the init, and the TPU kernel's is undefined."""
    _check_mode(mode)
    step = 2 if mode == "pair" else 1
    ct, cb = table.chunk_tile[0::step].long(), table.chunk_base[0::step]
    out = torch.zeros(table.num_tiles, dtype=torch.bool, device=ct.device)
    out[ct[cb == 0]] = True
    return out


def _sequences(mode: str, table: ChunkTable, tile_cnt: list[int]) -> list[tuple[int, list[tuple[int, int]]]]:
    """Per owner tile the chunks it composites, in order, as (tile, base):
    its own list for every mode but ``pair``; for ``pair`` the chunks of the
    steps whose first chunk it owns, if its first such step starts at base 0.
    Chunks past their tile's count are no-ops and left out; an owner stops at
    its own first such chunk, past which every step is padding."""
    if mode != "pair":
        return [(t, [(t, b) for b in range(0, n, CHUNK)]) for t, n in enumerate(tile_cnt) if n > 0]
    ct, cb, cc = (x.tolist() for x in (table.chunk_tile, table.chunk_base, table.chunk_cnt))
    lo, hi = (x.tolist() for x in _pair_ranges(table))
    seqs = []
    for t in range(table.num_tiles):
        if lo[t] == hi[t] or cb[2 * lo[t]] != 0:
            continue  # never initialised: undefined on the TPU
        items = []
        for c in range(2 * lo[t], 2 * hi[t]):
            if cb[c] >= cc[c]:
                if ct[c] == t:
                    break
                continue
            items.append((ct[c], cb[c]))
        seqs.append((t, items))
    return seqs


def _excl_cumsum(x: torch.Tensor) -> torch.Tensor:
    c = torch.cumsum(x, -1)
    return torch.cat([torch.zeros_like(c[..., :1]), c[..., :-1]], -1)


def _excl_cumprod(x: torch.Tensor) -> torch.Tensor:
    c = torch.cumprod(x, -1)
    return torch.cat([torch.ones_like(c[..., :1]), c[..., :-1]], -1)


def _chunk_alpha(mode, src, base, xys, conics, opacs, bins: TileBins, tiles_x):
    """Slots [base, base + 128) of tile ``src``'s list against that tile's
    pixels: the gaussians (B, 128), whether each slot is in the list, the
    pixels' coordinates (B, 256) and aeff (B, 256, 128), the alpha of the
    pairs that pass the alpha test and 0 elsewhere."""
    cnt = bins.tile_cnt[src].long()
    slot = base[:, None] + torch.arange(CHUNK, device=base.device)
    valid = slot < cnt[:, None]  # (B, 128)
    g = bins.gid[torch.where(valid, bins.tile_start[src].long()[:, None] + slot, 0)].long()
    px, py = _pixel_grid(tiles_x, src, xys.dtype)  # (B, 256)
    xy, con = _gather(xys, g), _gather(conics, g)
    dx = xy[:, None, :, 0] - px[:, :, None]  # (B, 256, 128)
    dy = xy[:, None, :, 1] - py[:, :, None]
    ca, cb, cc = con[:, None, :, 0], con[:, None, :, 1], con[:, None, :, 2]
    sigma = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
    vis = 1.0 / (1.0 + sigma) if mode == "notrans" else torch.exp(-sigma)
    alpha = torch.clamp(_gather(opacs, g)[:, None, :] * vis, max=ALPHA_CLAMP)
    ok = valid[:, None, :] & (sigma >= 0.0) & (alpha >= MIN_ALPHA)
    return g, valid, px, py, torch.where(ok, alpha, 0.0)


def _chunk_step(mode, state, owner, src, base, xys, conics, colors, opacs, bins: TileBins, tiles_x) -> tuple[int, int]:
    """Composite one chunk (slots [base, base + 128) of tile ``src``'s list)
    into each owner's pixels; returns the slots in the list and the pairs
    composited."""
    T, done, img, band = state
    g, valid, _, _, aeff = _chunk_alpha(mode, src, base, xys, conics, opacs, bins, tiles_x)
    one_minus = 1.0 - aeff
    T_carry = T[owner][:, :, None]
    d = done[owner][:, :, None]
    if mode == "nomatmul":
        T_excl = T_carry.expand_as(aeff)
    elif mode == "scan":
        T_excl = T_carry * _excl_cumprod(one_minus)
    else:
        L = -aeff if mode == "notrans" else torch.log1p(-aeff)
        T_excl = T_carry * torch.exp(_excl_cumsum(L))
    T_after = T_excl * one_minus
    live = (aeff > 0.0) & ~d
    comp = (T_after > T_EPS) & live
    w = torch.where(comp, aeff * T_excl, 0.0)
    img[owner] += torch.bmm(w, _gather(colors, g))
    band[owner] |= (((T_after - T_EPS).abs() <= STOP_BAND * T_EPS) & live).any(-1)
    T[owner] = torch.where(comp, T_after, T_carry).amin(-1)
    broke = torch.where(aeff > 0.0, T_after, 1.0).amin(-1) <= T_EPS
    done[owner] = d[..., 0] | broke
    return int(valid.sum()), int(comp.sum())


def _sequence_table(mode, table: ChunkTable, bins: TileBins, dev):
    """``_sequences`` as tensors: the owners (R,) and, per owner and chunk of
    its sequence (R, L), the source tile, the base and whether it is there;
    None where no tile composites anything."""
    seqs = _sequences(mode, table, bins.tile_cnt.tolist())
    if not seqs:
        return None
    L = max(len(items) for _, items in seqs)
    owners = torch.tensor([t for t, _ in seqs], device=dev)
    src = torch.tensor([[s for s, _ in items] + [0] * (L - len(items)) for _, items in seqs], device=dev)
    base = torch.tensor([[b for _, b in items] + [0] * (L - len(items)) for _, items in seqs], device=dev)
    has = torch.tensor([[True] * len(items) + [False] * (L - len(items)) for _, items in seqs], device=dev)
    return owners, src, base, has


def variant_plain_run(
    mode: str,
    xys: torch.Tensor,
    conics: torch.Tensor,
    colors: torch.Tensor,
    opacs: torch.Tensor,
    bins: TileBins,
    img_height: int,
    img_width: int,
    capacity: int = CAPACITY,
    table: ChunkTable | None = None,
) -> VariantRun:
    """The plain version of mode ``mode`` with its evaluated work and the
    pixels with a stop decision within STOP_BAND (relative) of T_EPS."""
    _check_mode(mode)
    tiles_x = (img_width + BLOCK - 1) // BLOCK
    num_tiles = tiles_x * ((img_height + BLOCK - 1) // BLOCK)
    if table is None:
        table = bins_chunk_table(bins, img_height, img_width, capacity)
    opacs = opacs.reshape(-1)
    dev, C = xys.device, colors.shape[1]
    T = torch.ones((num_tiles, P), dtype=xys.dtype, device=dev)
    done = torch.zeros((num_tiles, P), dtype=torch.bool, device=dev)
    img = torch.zeros((num_tiles, P, C), dtype=xys.dtype, device=dev)
    band = torch.zeros((num_tiles, P), dtype=torch.bool, device=dev)
    stop_chunk = torch.full((num_tiles, P), NEVER_DONE, dtype=torch.long, device=dev)
    n_chunks = n_slots = n_comp = 0
    seq = None if mode == "empty" else _sequence_table(mode, table, bins, dev)
    if seq is not None:
        owners, src, base, has = seq
        all_done = torch.zeros(num_tiles, dtype=torch.bool, device=dev)
        for j in range(has.shape[1]):
            rows = torch.nonzero(has[:, j] & ~all_done[owners]).flatten()
            for r in rows.split(_BATCH_OWNERS):
                o = owners[r]
                was = done[o]
                slots, comp = _chunk_step(mode, (T, done, img, band), o, src[r, j], base[r, j], xys, conics, colors,
                                          opacs, bins, tiles_x)
                n_slots, n_comp = n_slots + slots, n_comp + comp
                stop_chunk[o] = torch.where(done[o] & ~was, j, stop_chunk[o])
                all_done[o] = done[o].all(-1)
            n_chunks += len(rows)
    out = torch.zeros((num_tiles, P, NCOL), dtype=xys.dtype, device=dev)
    out[..., :C] = img
    out[..., COL_T] = T
    out[..., COL_DONE] = done.to(out.dtype)
    return VariantRun(out=out, band=band, chunks=n_chunks, pairs=P * n_slots, composited=n_comp,
                      stop_chunk=stop_chunk)


def variant_pairs(mode: str, run: VariantRun, xys, conics, opacs, bins: TileBins, img_height: int, img_width: int,
                  table: ChunkTable) -> tuple[int, int]:
    """The (pixel, gaussian) pairs kernel B1v evaluates in mode ``mode`` and,
    of those, the live ones, on the inputs of the plain run ``run``: a pair of
    a pixel not done at its chunk's start is evaluated where its gaussian's
    footprint box, at the mode's skip level, meets the pixel's warp (as
    ``ops/blend.tile_pairs`` counts B1's), and live where it passes the alpha
    test (aeff > 0), which no pair outside its box does."""
    _check_mode(mode)
    seq = None if mode == "empty" else _sequence_table(mode, table, bins, xys.device)
    if seq is None:
        return 0, 0
    tiles_x = (img_width + BLOCK - 1) // BLOCK
    opacs = opacs.reshape(-1)
    box = footprint_box(xys, conics, opacs, reciprocal=mode == "notrans")
    owners, src, base, has = seq
    evaluated = live = torch.zeros((), dtype=torch.long, device=xys.device)
    for j in range(has.shape[1]):
        walking = run.stop_chunk[owners] >= j  # (R, 256): not done at chunk j's start
        for r in torch.nonzero(has[:, j] & walking.any(-1)).flatten().split(_BATCH_OWNERS):
            g, valid, px, py, aeff = _chunk_alpha(mode, src[r, j], base[r, j], xys, conics, opacs, bins, tiles_x)
            w = walking[r][:, :, None]
            evaluated = evaluated + (warp_meets(box[g], px, py) & valid[:, None, :] & w).sum()
            live = live + ((aeff > 0.0) & w).sum()
    return int(evaluated), int(live)


def blend_variant_plain(mode, xys, conics, colors, opacs, bins: TileBins, img_height: int, img_width: int,
                        capacity: int = CAPACITY, table: ChunkTable | None = None) -> torch.Tensor:
    """(num_tiles, 256, 16): mode ``mode`` of the variant kernel, plain."""
    return variant_plain_run(mode, xys, conics, colors, opacs, bins, img_height, img_width, capacity, table).out


def tiles_to_image(out: torch.Tensor, img_height: int, img_width: int, n_chan: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Block layout → (image (H, W, C), transmittance (H, W))."""
    tiles_x = (img_width + BLOCK - 1) // BLOCK
    tiles_y = (img_height + BLOCK - 1) // BLOCK
    blocks = out.reshape(tiles_y, tiles_x, BLOCK, BLOCK, NCOL).permute(0, 2, 1, 3, 4)
    blocks = blocks.reshape(tiles_y * BLOCK, tiles_x * BLOCK, NCOL)[:img_height, :img_width]
    return blocks[..., :n_chan], blocks[..., COL_T]


def blend_variant(
    mode: str,
    xys: torch.Tensor,  # (N, 2) original order
    conics: torch.Tensor,  # (N, 3)
    colors: torch.Tensor,  # (N, C), C ≤ 8
    opacs: torch.Tensor,  # (N,) or (N, 1)
    bins: TileBins,
    img_height: int,
    img_width: int,
    capacity: int = CAPACITY,
    table: ChunkTable | None = None,
) -> torch.Tensor:
    """(num_tiles, 256, 16): mode ``mode`` of the variant kernel. The plain
    version for CPU tensors; kernel B1v for CUDA ones, or it raises. It never
    falls back. ``table`` (from ``bins_chunk_table``) saves rebuilding it."""
    _check_mode(mode)
    opacs = opacs.reshape(-1)
    if xys.device.type == "cpu":
        return blend_variant_plain(mode, xys, conics, colors, opacs, bins, img_height, img_width, capacity, table)
    if xys.device.type != "cuda":
        raise ValueError(f"no blend variant for device {xys.device}")
    _, C, tiles_x, tiles_y = blend_cuda._check_inputs(xys, conics, colors, opacs, bins, img_height, img_width)
    num_tiles = tiles_x * tiles_y
    dev = xys.device
    out = torch.empty((num_tiles, P, NCOL), dtype=torch.float32, device=dev)
    if num_tiles == 0:
        return out
    ptrs = (None,) * 5  # the chunk table and pair ranges, read by "pair" only
    if mode == "pair":
        if table is None:
            table = bins_chunk_table(bins, img_height, img_width, capacity)
        if table.num_tiles != num_tiles or table.chunk_tile.device != dev:
            raise ValueError("the chunk table is not of these bins' tiles on this device")
        ptrs = (table.chunk_tile, table.chunk_base, table.chunk_cnt, *_pair_ranges(table))
        for name, t in zip(("chunk_tile", "chunk_base", "chunk_cnt", "pair_lo", "pair_hi"), ptrs):
            blend_cuda._check(name, t, torch.int32, tuple(t.shape), dev)
    lib = cuda_build.load("blend_variants", _ARGTYPES)
    with torch.cuda.device(dev):
        err = lib.gctorch_blend_variants(
            MODES.index(mode), xys.data_ptr(), conics.data_ptr(), colors.data_ptr(), opacs.data_ptr(),
            bins.gid.data_ptr(), bins.tile_start.data_ptr(), bins.tile_cnt.data_ptr(),
            *(None if t is None else t.data_ptr() for t in ptrs),
            out.data_ptr(), num_tiles, tiles_x, C, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"blend_variants kernel launch failed with CUDA error {err}")
    launches[mode] += 1
    return out
