"""The hand-written CUDA kernels of the solver's level loop, and their
plain PyTorch versions.

The counterpart of the JAX package's ``ops/pallas_kernels.py``. Each kernel
has three parts here:

* ``<name>_torch``: the plain PyTorch version of the same function. The
  tests run it on the CPU, and the card check holds the kernel against it.
* ``<name>``: the wrapper. A CPU tensor takes the plain version; a CUDA
  tensor launches the kernel (``csrc/<name>.cu``) or raises. Nothing falls
  back.
* ``<name>.launches``: a plain int that the wrapper raises by one each time
  it launches the kernel, so a run can show that it went through the kernel.
  K3 has two wrappers, one bucket (``ell_row_min``) and a whole level
  (``ell_level_min``), over one kernel; both count on ``ell_row_min``.

The library builds at first use (``ops/_build.py``). Right after it loads,
the K4 probe runs once as a self-check and the load fails unless it reads 3.

A launch costs the host a few microseconds, so the launch path does no more
than it must: ``_validate`` reads tensor attributes and builds no
``torch.device``; the stream is the raw handle of the device's current
stream, read with ``_current_stream`` and never built into a
``torch.cuda.Stream``; one call into the extension module launches
(``csrc/bindings.cpp``, cheaper than ``ctypes``), and the C launcher sets
the device only where it is not already current.
"""

from __future__ import annotations

import math
import threading
from typing import NamedTuple

import numpy as np
import torch

from distributed_ghs_implementation_tpu_torch.ops import _build

INT32_MAX = 2**31 - 1

_LIB = None
#: Held by the one thread that builds, loads and self-checks the library;
#: threads that come at the same time wait for it and reuse ``_LIB``.
_LIB_LOCK = threading.Lock()
#: ``torch._C._cuda_getCurrentRawStream``: the raw handle of a device's
#: current stream, read without building a ``torch.cuda.Stream`` object.
#: Bound by ``_lib()``; CPU builds of torch do not have it.
_current_stream = None


def _lib():
    """The loaded kernel library; the first call builds, loads and runs the
    probe self-check, under a lock, so that of several threads calling at
    once one does it and the others reuse its library."""
    global _LIB, _current_stream
    if _LIB is not None:
        return _LIB
    with _LIB_LOCK:
        if _LIB is None:
            raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)
            if raw_stream is None:
                raise RuntimeError(
                    "this build of torch has no torch._C._cuda_getCurrentRawStream; "
                    "the kernels need a CUDA build of torch"
                )
            _current_stream = raw_stream
            lib = _build.load_library()
            _self_check(lib)
            _LIB = lib
    return _LIB


def _self_check(lib) -> None:
    """The K4 probe on the card; the load fails unless it reads 3."""
    table = torch.arange(256, dtype=torch.int32, device="cuda")
    idx = torch.full((2, 128), 3, dtype=torch.int32, device="cuda")
    out = torch.empty_like(idx)
    _launch_probe(lib, table.get_device(), table, idx, out, idx.numel())
    if not bool((out == 3).all()):
        raise RuntimeError(f"kernel self-check read {out.unique().tolist()}, not [3]")


def _fail(name: str, lib, code: int):
    msg = lib.error_string(code)
    raise RuntimeError(f"{name} kernel launch failed: CUDA error {code} ({msg})")


def _validate(name: str, tensors: dict, dtypes: dict | None = None) -> int:
    """All CUDA, one device, contiguous, int32 unless ``dtypes`` names another
    type; return the device's index. Reads tensor attributes only: it runs on
    every launch."""
    index = None
    for key, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(
                f"{name}: {key} is on {t.device}; expected CUDA or CPU tensors, all on one device"
            )
        device = t.get_device()
        if index is None:
            index = device
        elif device != index:
            raise ValueError(f"{name}: tensors on several devices (cuda:{index}, cuda:{device})")
        dtype = torch.int32 if dtypes is None else dtypes.get(key, torch.int32)
        if t.dtype is not dtype:
            raise TypeError(f"{name}: {key} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    return index


# ---------------------------------------------------------------------------
# K2 gather_key (csrc/gather_key.cu)
# ---------------------------------------------------------------------------
def gather_key_torch(fragment, src, dst, rank):
    """``(fragment[src], key)`` with ``key = rank`` where the slot leaves its
    fragment and INT32_MAX where it does not."""
    fs = fragment[src]
    fd = fragment[dst]
    return fs, torch.where(fs != fd, rank, INT32_MAX)


def gather_key(fragment, src, dst, rank):
    """K2: the non-identity ``fragment_moe`` front half. Replaces
    ``fused_gather_key`` (JAX package ``ops/pallas_kernels.py:492``)."""
    if fragment.is_cpu:
        return gather_key_torch(fragment, src, dst, rank)
    device = _validate("gather_key", {
        "fragment": fragment, "src": src, "dst": dst, "rank": rank,
    })
    if fragment.dim() != 1 or src.dim() != 1 or not (src.shape == dst.shape == rank.shape):
        raise ValueError(
            f"gather_key: want fragment[n] and src/dst/rank[e], got "
            f"{tuple(fragment.shape)}, {tuple(src.shape)}, {tuple(dst.shape)}, "
            f"{tuple(rank.shape)}"
        )
    fsrc = torch.empty_like(src)
    key = torch.empty_like(src)
    e = src.numel()
    if e:
        lib = _lib()
        code = lib.gather_key(
            device, fragment.data_ptr(), src.data_ptr(), dst.data_ptr(),
            rank.data_ptr(), fsrc.data_ptr(), key.data_ptr(), e, _current_stream(device),
        )
        if code:
            _fail("gather_key", lib, code)
        gather_key.launches += 1
    return fsrc, key


gather_key.launches = 0


# ---------------------------------------------------------------------------
# K1 hook_compress (csrc/hook_compress.cu)
# ---------------------------------------------------------------------------
def num_jumps(n: int) -> int:
    """Pointer jumps that reach the root from any depth a forest of ``n``
    nodes can hold."""
    return max(1, math.ceil(math.log2(max(2, n))))


def hook_compress_torch(has_moe, moe_dst_frag, fragment):
    """Hook, break mutual pairs, ``num_jumps(n)`` pointer jumps, relabel:
    returns ``(new_fragment, parent)``."""
    n = fragment.shape[0]
    ids = torch.arange(n, dtype=torch.int32, device=fragment.device)
    p = torch.where(has_moe, moe_dst_frag, ids)
    p = torch.where((p[p] == ids) & (ids < p), ids, p)
    for _ in range(num_jumps(n)):
        p = p[p]
    return p[fragment], p


#: The block form's limits, as ``csrc/hook_compress.cu`` sets them
#: (``kBlockMaxNodes``, ``kBlockFormThreshold``): the most nodes its shared
#: memory holds, and the most for which ``form="auto"`` picks it.
HOOK_BLOCK_MAX_NODES = 29056
HOOK_BLOCK_FORM_THRESHOLD = 8192

#: ``form`` of :func:`hook_compress` and the launcher's code for it:
#: ``"auto"`` picks by n (the block form up to the threshold in
#: ``csrc/hook_compress.cu``, the grid form above); the others force one.
HOOK_FORMS = {"auto": 0, "block": 1, "grid": 2}


def hook_compress(has_moe, moe_dst_frag, fragment, *, form: str = "auto"):
    """K1: one merge round, the contract of ``union_find.hook_and_compress``,
    in one launch. Replaces ``fused_hook_compress`` (JAX package
    ``ops/pallas_kernels.py:516``). The kernel stops jumping at the first
    jump that changes nothing, which gives what all ``num_jumps(n)`` jumps
    give; :func:`hook_compress_readout` says how many it ran."""
    if form not in HOOK_FORMS:
        raise ValueError(f"hook_compress: form must be one of {sorted(HOOK_FORMS)}, got {form!r}")
    if fragment.is_cpu:
        return hook_compress_torch(has_moe, moe_dst_frag, fragment)
    device = _validate(
        "hook_compress",
        {"has_moe": has_moe, "moe_dst_frag": moe_dst_frag, "fragment": fragment},
        {"has_moe": torch.bool},
    )
    n = fragment.numel()
    if fragment.dim() != 1 or has_moe.shape != (n,) or moe_dst_frag.shape != (n,):
        raise ValueError(
            f"hook_compress: want has_moe/moe_dst_frag/fragment all [n], got "
            f"{tuple(has_moe.shape)}, {tuple(moe_dst_frag.shape)}, {tuple(fragment.shape)}"
        )
    new_fragment = torch.empty_like(fragment)
    parent = torch.empty_like(fragment)
    if n:
        jumps = num_jumps(n)
        # One allocation: the grid form's ping-pong buffer [n], one early-exit
        # flag a jump, then the read-out (jumps taken, form run).
        scratch = fragment.new_empty(n + jumps + 2)
        lib = _lib()
        code = lib.hook_compress(
            device, has_moe.data_ptr(), moe_dst_frag.data_ptr(), fragment.data_ptr(),
            new_fragment.data_ptr(), parent.data_ptr(), scratch.data_ptr(), n, jumps,
            HOOK_FORMS[form], _current_stream(device),
        )
        if code:
            _fail("hook_compress", lib, code)
        hook_compress.launches += 1
        hook_compress.readout = (scratch, n + jumps)
    return new_fragment, parent


def hook_compress_readout() -> tuple[int, str]:
    """``(jumps taken, "block" or "grid")`` of the last K1 launch. Reads the
    card, so it waits for the launch."""
    scratch, at = hook_compress.readout
    jumps, form = scratch[at:at + 2].tolist()
    return jumps, {1: "block", 2: "grid"}[form]


hook_compress.launches = 0
hook_compress.readout = None


# ---------------------------------------------------------------------------
# K4 probe (csrc/probe.cu)
# ---------------------------------------------------------------------------
def probe_torch(table, idx):
    """``table[idx]``."""
    return table[idx]


def _launch_probe(lib, device: int, table, idx, out, count: int) -> None:
    code = lib.probe(
        device, table.data_ptr(), idx.data_ptr(), out.data_ptr(), count,
        _current_stream(device),
    )
    if code:
        _fail("probe", lib, code)
    probe.launches += 1


def probe(table, idx):
    """K4: the gather ``table[idx]`` the load-time self-check runs. Replaces
    the capability probe ``_probe`` (JAX package ``ops/pallas_kernels.py:210``).
    It is the cheapest launch there is, so its time is the launch path's."""
    if table.is_cpu:
        return probe_torch(table, idx)
    device = _validate("probe", {"table": table, "idx": idx})
    out = torch.empty_like(idx)
    count = idx.numel()
    if count:
        _launch_probe(_lib(), device, table, idx, out, count)
    return out


probe.launches = 0


# ---------------------------------------------------------------------------
# K3 ell_row_min (csrc/ell_row_min.cu)
# ---------------------------------------------------------------------------
def ell_row_min_torch(fragment, verts, dstb, rankb):
    """Per ELL row, the least rank among the row's slots that leave the
    row vertex's fragment; INT32_MAX where none does."""
    fv = fragment[verts]
    fd = fragment[dstb]
    return torch.where(fd != fv[:, None], rankb, INT32_MAX).amin(1)


def ell_level_min_torch(fragment, plan, vmin):
    """For every row of every bucket of ``plan``, ``vmin[verts[r]] =
    min(vmin[verts[r]], row minimum of r)``, in place; returns ``vmin``."""
    for verts, dstb, rankb in plan.buckets:
        # Pad rows alias vertex 0 with INT32_MAX: a min-scatter, not a store.
        vmin.scatter_reduce_(0, verts.long(), ell_row_min_torch(fragment, verts, dstb, rankb),
                             "amin")
    return vmin


#: Slots of one K3 tile: a block's share of a level. chip_smoke.py's "K3
#: tiles" line times one RMAT-18 level at 1,024-16,384: on an H100 8,192 was
#: the fastest, by about 1% over 4,096, and 1,024 the slowest, by 24%.
ELL_TILE_SLOTS = 8192
#: Buckets one K3 launch takes: their descriptors travel as kernel
#: parameters, which are limited to 4 KB.
ELL_MAX_BUCKETS = 32
#: The fields of one bucket's descriptor, as ``EllBucket`` in
#: ``csrc/ell_row_min.cu`` lays them out (all 64-bit).
ELL_FIELDS = ("verts", "dstb", "rankb", "rows", "width", "first_tile", "rows_per_tile", "seg",
              "chunks")


class EllPlan(NamedTuple):
    """A level's buckets laid out as K3 tiles; built once per solve."""

    buckets: tuple  # ((verts, dstb, rankb), ...): kept alive for the descriptors
    desc: torch.Tensor  # int64 [buckets, len(ELL_FIELDS)] on the host
    tiles: int
    device: int | None  # the buckets' CUDA device; None on the CPU


def ell_tiling(shapes, tile_slots: int = ELL_TILE_SLOTS):
    """Cut buckets of ``(rows, W)`` into tiles of at most ``tile_slots``
    slots: ``[(first_tile, rows_per_tile, seg, chunks)]`` per bucket and the
    tile count. A bucket with W <= ``tile_slots`` takes ``tile_slots // W``
    whole rows a tile; a wider row splits into ``ceil(W / tile_slots)``
    chunks of ``tile_slots`` slots (the last one shorter), each a tile."""
    if tile_slots < 1:
        raise ValueError(f"tile_slots must be >= 1, got {tile_slots}")
    out, first = [], 0
    for rows, width in shapes:
        if width <= tile_slots:
            per_tile, seg, chunks = tile_slots // width, width, 1
            tiles = -(-rows // per_tile)
        else:
            per_tile, seg, chunks = 1, tile_slots, -(-width // tile_slots)
            tiles = rows * chunks
        out.append((first, per_tile, seg, chunks))
        first += tiles
    return out, first


def _check_bucket(name: str, verts, dstb, rankb) -> None:
    if (verts.dim() != 1 or dstb.dim() != 2 or dstb.shape[1] < 1
            or dstb.shape != rankb.shape or dstb.shape[0] != verts.shape[0]):
        raise ValueError(
            f"{name}: want verts[rows] and dstb/rankb[rows, W >= 1], got "
            f"{tuple(verts.shape)}, {tuple(dstb.shape)}, {tuple(rankb.shape)}"
        )


def _plan(buckets, tile_slots: int, device) -> EllPlan:
    tiling, tiles = ell_tiling([tuple(b[1].shape) for b in buckets], tile_slots)
    desc = torch.tensor(
        [[v.data_ptr(), d.data_ptr(), r.data_ptr(), *d.shape, *t]
         for (v, d, r), t in zip(buckets, tiling)],
        dtype=torch.int64,
    ).reshape(-1, len(ELL_FIELDS))
    return EllPlan(buckets, desc, tiles, device)


def ell_plan(buckets, *, tile_slots: int = ELL_TILE_SLOTS) -> EllPlan:
    """The plan of K3's one launch a level over ``buckets`` (``(verts, dstb,
    rankb)`` each, as ``Graph.ell_buckets`` stages them): at most
    ``ELL_MAX_BUCKETS`` buckets, all on one device."""
    buckets = tuple(tuple(b) for b in buckets)
    if len(buckets) > ELL_MAX_BUCKETS:
        raise ValueError(
            f"ell_plan: {len(buckets)} buckets; one K3 launch takes at most {ELL_MAX_BUCKETS}"
        )
    for i, (verts, dstb, rankb) in enumerate(buckets):
        _check_bucket(f"ell_plan bucket {i}", verts, dstb, rankb)
    device = None
    if buckets and not buckets[0][0].is_cpu:
        device = _validate("ell_plan", {
            f"{key}{i}": t for i, b in enumerate(buckets) for key, t in zip(ELL_FIELDS, b)
        })
    return _plan(buckets, tile_slots, device)


def _launch_ell_level(device: int, fragment, out, plan: EllPlan, row_indexed: int) -> None:
    lib = _lib()
    code = lib.ell_level(
        device, fragment.data_ptr(), out.data_ptr(), plan.desc.data_ptr(), len(plan.buckets),
        plan.tiles, row_indexed, _current_stream(device),
    )
    if code:
        _fail("ell_row_min", lib, code)
    ell_row_min.launches += 1


def ell_row_min(fragment, verts, dstb, rankb):
    """K3 on one ELL bucket: its masked row minimum. Replaces
    ``fused_ell_row_min`` (JAX package ``ops/pallas_kernels.py:465``). The
    one-bucket call of the level kernel, into a row-indexed output preset to
    INT32_MAX."""
    if fragment.is_cpu:
        return ell_row_min_torch(fragment, verts, dstb, rankb)
    device = _validate("ell_row_min", {
        "fragment": fragment, "verts": verts, "dstb": dstb, "rankb": rankb,
    })
    if fragment.dim() != 1:
        raise ValueError(f"ell_row_min: want fragment[n], got {tuple(fragment.shape)}")
    _check_bucket("ell_row_min", verts, dstb, rankb)
    out = torch.full_like(verts, INT32_MAX)
    plan = _plan(((verts, dstb, rankb),), ELL_TILE_SLOTS, device)
    if plan.tiles:
        _launch_ell_level(device, fragment, out, plan, 1)
    return out


def ell_level_min(fragment, plan: EllPlan, vmin):
    """K3 over a whole ELL level in one launch: ``ell_level_min_torch``'s
    function, the per-vertex minima folded in with atomics. ``vmin`` is
    updated in place (the caller presets it to INT32_MAX) and returned."""
    if fragment.is_cpu:
        return ell_level_min_torch(fragment, plan, vmin)
    device = _validate("ell_level_min", {"fragment": fragment, "vmin": vmin})
    if fragment.dim() != 1 or vmin.shape != fragment.shape:
        raise ValueError(
            f"ell_level_min: want fragment[n] and vmin[n], got {tuple(fragment.shape)}, "
            f"{tuple(vmin.shape)}"
        )
    if plan.device != device:
        raise ValueError(
            f"ell_level_min: the plan's buckets are on "
            f"{'the CPU' if plan.device is None else f'cuda:{plan.device}'}, fragment on "
            f"cuda:{device}"
        )
    if plan.tiles:
        _launch_ell_level(device, fragment, vmin, plan, 0)
    return vmin


ell_row_min.launches = 0


# ---------------------------------------------------------------------------
# K5 gather (csrc/gather.cu)
# ---------------------------------------------------------------------------
def gather_torch(table, idx):
    """``table[idx]``."""
    return table[idx.long()]


def gather(table, idx):
    """K5: the random gather ``out[i] = table[idx[i]]`` of the gather
    microbenchmark (``gather_probe``). Replaces ``pallas_gather`` (JAX
    package tool ``tools/test_pallas_gather.py:46``). Indices must lie in
    ``[0, len(table))``; the kernel does not check them."""
    if table.is_cpu:
        return gather_torch(table, idx)
    device = _validate("gather", {"table": table, "idx": idx})
    if table.dim() != 1 or idx.dim() != 1:
        raise ValueError(
            f"gather: want table[n] and idx[m], got {tuple(table.shape)}, {tuple(idx.shape)}"
        )
    out = torch.empty_like(idx)
    count = idx.numel()
    if count:
        lib = _lib()
        code = lib.gather(
            device, table.data_ptr(), idx.data_ptr(), out.data_ptr(), count,
            _current_stream(device),
        )
        if code:
            _fail("gather", lib, code)
        gather.launches += 1
    return out


gather.launches = 0


# ---------------------------------------------------------------------------
# K6 first_rank (csrc/first_rank.cu)
# ---------------------------------------------------------------------------
def first_rank_torch(ra, rb, m: int, n_pad: int):
    """``vmin[x]``, the least rank ``r < m`` with ``ra[r] == x`` or ``rb[r]
    == x``, over ``n_pad`` vertices; INT32_MAX where there is none. The
    segment minimum of the ranks over both endpoints, exact."""
    r = torch.arange(m, dtype=torch.int32, device=ra.device)
    out = torch.full((n_pad,), INT32_MAX, dtype=torch.int32, device=ra.device)
    return out.scatter_reduce_(0, torch.cat([ra[:m], rb[:m]]).long(), torch.cat([r, r]), "amin")


def first_rank(ra, rb, m: int, n_pad: int):
    """K6: each vertex's least incident rank over the first ``m`` ranks,
    the rank route's level-1 input. Replaces no TPU kernel: the JAX
    package runs this pass on the host (``Graph.first_ranks``). Pad ranks
    ``r >= m`` are never read. Vertex ids must lie in ``[0, n_pad)``; the
    kernel does not check them."""
    if ra.is_cpu:
        return first_rank_torch(ra, rb, m, n_pad)
    device = _validate("first_rank", {"ra": ra, "rb": rb})
    if ra.dim() != 1 or rb.shape != ra.shape or not 0 <= m <= ra.numel() or n_pad < 0:
        raise ValueError(
            f"first_rank: want ra/rb[m_pad], 0 <= m <= m_pad and n_pad >= 0, got "
            f"{tuple(ra.shape)}, {tuple(rb.shape)}, m={m}, n_pad={n_pad}"
        )
    vmin = torch.full((n_pad,), INT32_MAX, dtype=torch.int32, device=ra.device)
    if m and n_pad:
        lib = _lib()
        code = lib.first_rank(device, ra.data_ptr(), rb.data_ptr(), vmin.data_ptr(), m,
                              _current_stream(device))
        if code:
            _fail("first_rank", lib, code)
        first_rank.launches += 1
    return vmin


first_rank.launches = 0


# ---------------------------------------------------------------------------
# K7 rank_order and its endpoint gather (csrc/rank_order.cu)
# ---------------------------------------------------------------------------
#: The widest integer weight range the 32-bit key takes: ``whigh - wlow + 1``
#: values at most, the host's counting-sort rule
#: (``native.rank_order_counting``). Every other weight takes the 64-bit key.
RANK_ORDER_MAX_RANGE = 1 << 22
#: The launcher's ``kind`` of each 64-bit key (``csrc/rank_order.cu``).
RANK_KEY64_KINDS = {"int64": 0, "float64": 1}
#: The 8-bit digits of a 64-bit key.
RANK_KEY64_DIGITS = 8
_INT64_MIN = -(1 << 63)
_INT64_MAX = (1 << 63) - 1
_QUIET_NAN_BITS = 0x7FF8000000000000


class RankOrder(NamedTuple):
    """One sort of :func:`sort_rank_order`: ``order[r]``, the edge of rank
    ``r`` (int32); the key it sorted (``"int32"``, ``"int64"`` or
    ``"float64"``); and the digit passes it ran (on the CPU, the passes the
    kernel would run)."""

    order: torch.Tensor
    key: str
    passes: int


def rank_order_passes(wlow: int, whigh: int) -> int:
    """The 8-bit digit passes that sort 32-bit keys in ``[0, whigh - wlow]``:
    at least one."""
    return max(1, -(-(whigh - wlow).bit_length() // 8))


def rank_key(w, wlow: int | None = None, whigh: int | None = None) -> str:
    """The key K7 sorts ``w`` by: ``"int32"`` (``w - wlow``) for int64
    weights in ``[wlow, whigh]``, a range of at most
    ``RANK_ORDER_MAX_RANGE`` values; ``"int64"`` for other int64 weights
    (or no range given); ``"float64"`` for float64 weights."""
    if w.dtype is torch.float64:
        return "float64"
    if w.dtype is not torch.int64:
        raise TypeError(f"rank_order: w must be torch.int64 or torch.float64, got {w.dtype}")
    if wlow is None or whigh - wlow >= RANK_ORDER_MAX_RANGE:
        return "int64"
    return "int32"


def _check_rank_order(w, wlow, whigh) -> str:
    """The key of ``w`` (:func:`rank_key`), once the call is checked."""
    if w.dim() != 1 or (wlow is None) is not (whigh is None) or (
            wlow is not None and whigh < wlow):
        raise ValueError(
            f"rank_order: want w[m] and either no weight range or one of at least one value, "
            f"got {tuple(w.shape)}, [{wlow}, {whigh}]"
        )
    return rank_key(w, wlow, whigh)


def rank_key64_torch(w):
    """K7's 64-bit key of int64 or float64 ``w`` less 2^63, as an int64
    whose signed order is the key's unsigned order: an int64 ``w`` as it
    is; a float64's bits with -0.0 read as +0.0, every NaN as one positive
    quiet NaN (after +inf), and the bits below the sign flipped where the
    sign is set."""
    if w.dtype is torch.int64:
        return w
    bits = w.view(torch.int64)
    bits = torch.where(bits == _INT64_MIN, 0, bits)
    bits = torch.where(torch.isnan(w), _QUIET_NAN_BITS, bits)
    return bits ^ ((bits >> 63) & _INT64_MAX)


def rank_key_bits_torch(key) -> tuple[int, int]:
    """The OR and the AND of :func:`rank_key64_torch`'s keys, as the
    kernel's first read gives them (for :func:`_digits_of_bits`)."""
    bits = key.numpy()
    return int(np.bitwise_or.reduce(bits)), int(np.bitwise_and.reduce(bits))


def _digits_of_bits(any_bits: int, all_bits: int) -> int:
    """The digit mask of keys whose OR is ``any_bits`` and AND ``all_bits``:
    a digit is the same in every key where the two agree."""
    spread = any_bits ^ all_bits
    return sum(1 << d for d in range(RANK_KEY64_DIGITS) if (spread >> (8 * d)) & 0xFF)


def rank_order_torch(w, wlow: int | None = None, whigh: int | None = None):
    """The edge ids by ``(w, edge id)``, int32: a stable sort of the key
    :func:`rank_key` names (``w - wlow``, or :func:`rank_key64_torch`)."""
    if _check_rank_order(w, wlow, whigh) == "int32":
        return torch.sort(w - wlow, stable=True).indices.to(torch.int32)
    return torch.sort(rank_key64_torch(w), stable=True).indices.to(torch.int32)


def sort_rank_order(w, wlow: int | None = None, whigh: int | None = None) -> RankOrder:
    """K7: the rank order of int64 or float64 weights ``w``, in the order of
    NumPy's stable argsort (equal weights by edge id; -0.0 equal to +0.0;
    NaN after +inf). Replaces no TPU kernel: the JAX package sorts on the
    host (``Graph._rank_order``). Int64 weights whose values lie in
    ``[wlow, whigh]``, a range of at most ``RANK_ORDER_MAX_RANGE`` values,
    sort by 32-bit keys in every digit pass :func:`rank_order_passes` names,
    one launch; the kernel does not check that they lie in the range. Other
    int64 weights (or no range given) and float64 weights sort by 64-bit
    keys: one read of the keys for their OR and AND, one host read of the
    two words, then one launch of a pass for each digit that is not the
    same in every key."""
    key = _check_rank_order(w, wlow, whigh)
    m = w.numel()
    if w.is_cpu:
        order = rank_order_torch(w, wlow, whigh)
        if not m:
            passes = 0
        elif key == "int32":
            passes = rank_order_passes(wlow, whigh)
        else:
            passes = bin(_digits_of_bits(*rank_key_bits_torch(rank_key64_torch(w)))).count("1")
        return RankOrder(order, key, passes)
    device = _validate("rank_order", {"w": w}, {"w": w.dtype})
    order = torch.empty(m, dtype=torch.int32, device=w.device)
    passes = 0
    if m:
        lib = _lib()
        stream = _current_stream(device)
        if key == "int32":
            passes = rank_order_passes(wlow, whigh)
            scratch = torch.empty(lib.rank_order_scratch(m, passes), dtype=torch.int32,
                                  device=w.device)
            code = lib.rank_order(device, w.data_ptr(), wlow, passes, order.data_ptr(),
                                  scratch.data_ptr(), scratch.numel(), m, stream)
        else:
            kind = RANK_KEY64_KINDS[key]
            bits = torch.empty(2, dtype=torch.int64, device=w.device)
            code = lib.rank_key_bits(device, w.data_ptr(), kind, bits.data_ptr(), m, stream)
            if code:
                _fail("rank_order", lib, code)
            digits = _digits_of_bits(*bits.tolist())
            passes = bin(digits).count("1")
            if digits:
                scratch = torch.empty(lib.rank_order64_scratch(m, passes), dtype=torch.uint8,
                                      device=w.device)
                code = lib.rank_order64(device, w.data_ptr(), kind, digits, order.data_ptr(),
                                        scratch.data_ptr(), scratch.numel(), m, stream)
            else:  # every key equal: the stable order is the edge ids'
                torch.arange(m, dtype=torch.int32, device=w.device, out=order)
        if code:
            _fail("rank_order", lib, code)
        rank_order.launches += 1
    return RankOrder(order, key, passes)


def rank_order(w, wlow: int | None = None, whigh: int | None = None):
    """The ``order`` of :func:`sort_rank_order`: ``order[r]``, the edge of
    rank ``r``, int32. A CPU tensor takes :func:`rank_order_torch`. K7's
    entry in ``WRAPPERS``, beside its plain version, as every kernel's is;
    its ``launches`` count :func:`sort_rank_order`'s launches."""
    return sort_rank_order(w, wlow, whigh).order


rank_order.launches = 0


def rank_endpoints_torch(order, u, v, m_pad: int):
    """``(u[order], v[order])`` as int32, zero-padded to ``m_pad``."""
    m = order.numel()
    ra = torch.zeros(m_pad, dtype=torch.int32, device=order.device)
    rb = torch.zeros_like(ra)
    idx = order.long()
    ra[:m] = u[idx].to(torch.int32)
    rb[:m] = v[idx].to(torch.int32)
    return ra, rb


def rank_endpoints(order, u, v, m_pad: int):
    """The endpoint gather after K7: ``ra[r] = u[order[r]]``, ``rb[r] =
    v[order[r]]`` for ``r < len(order)``, int32, and 0 up to ``m_pad``, from
    int32 tables ``u`` and ``v``. Replaces no TPU kernel: the JAX package
    gathers on the host (``Graph.rank_endpoints``). Edge ids must lie in
    ``[0, len(u))``; the kernel does not check them."""
    m = order.numel()
    if order.dim() != 1 or u.dim() != 1 or u.shape != v.shape or m_pad < m:
        raise ValueError(
            f"rank_endpoints: want order[m], u/v[n] and m_pad >= m, got "
            f"{tuple(order.shape)}, {tuple(u.shape)}, {tuple(v.shape)}, m_pad={m_pad}"
        )
    if order.is_cpu:
        return rank_endpoints_torch(order, u, v, m_pad)
    device = _validate("rank_endpoints", {"order": order, "u": u, "v": v})
    ra = torch.empty(m_pad, dtype=torch.int32, device=order.device)
    rb = torch.empty_like(ra)
    if m_pad:
        lib = _lib()
        code = lib.rank_endpoints(device, order.data_ptr(), u.data_ptr(), v.data_ptr(),
                                  ra.data_ptr(), rb.data_ptr(), m, m_pad, _current_stream(device))
        if code:
            _fail("rank_endpoints", lib, code)
        rank_endpoints.launches += 1
    return ra, rb


rank_endpoints.launches = 0

#: The wrapper that counts each kernel's launches, for code that reads or
#: resets the counts.
WRAPPERS = (gather_key, hook_compress, probe, ell_row_min, gather, first_rank, rank_order,
            rank_endpoints)


# ---------------------------------------------------------------------------
# Launch configs and the tuned table (tune/)
# ---------------------------------------------------------------------------
class LaunchConfig(NamedTuple):
    """What a solve may vary in how it launches the kernels without
    changing its result: K1's form and K3's tile. A tuning record
    (``tune/record.py``) holds one a solver bucket."""

    hook_form: str = "auto"
    tile_slots: int = ELL_TILE_SLOTS

    def to_json(self) -> dict:
        return {"hook_form": self.hook_form, "tile_slots": self.tile_slots}

    @staticmethod
    def from_json(d) -> "LaunchConfig":
        """Parse and check a config as a record stores it; raises
        ``ValueError`` naming what is wrong."""
        if not isinstance(d, dict) or set(d) != {"hook_form", "tile_slots"}:
            raise ValueError(f"launch config must have hook_form and tile_slots, got {d!r}")
        form, tile = d["hook_form"], d["tile_slots"]
        if form not in HOOK_FORMS:
            raise ValueError(f"hook_form must be one of {sorted(HOOK_FORMS)}, got {form!r}")
        if not isinstance(tile, int) or isinstance(tile, bool) or tile < 1:
            raise ValueError(f"tile_slots must be a positive int, got {tile!r}")
        return LaunchConfig(form, tile)


DEFAULT_CONFIG = LaunchConfig()

#: Installed per-bucket configs, ``(n_pad, m_pad, lanes, mode) ->
#: LaunchConfig``, and where they came from. ``tune.record.install_record``
#: is the one writer; the lane solvers, the single-card flat solve and the
#: ELL solve read their bucket's entry at each solve.
_TUNED: dict = {}
_TUNED_SOURCE: dict | None = None
_TUNED_LOCK = threading.Lock()


def set_tuned_configs(mapping: dict | None, source: dict | None = None) -> None:
    """Install ``bucket -> LaunchConfig`` (replacing what was installed);
    ``None`` uninstalls. ``source`` is a small provenance dict that
    :func:`tuned_summary` reports."""
    global _TUNED, _TUNED_SOURCE
    table = {}
    for bucket, config in (mapping or {}).items():
        if not isinstance(config, LaunchConfig):
            raise TypeError(f"tuned config for bucket {bucket!r} must be a LaunchConfig")
        table[tuple(bucket)] = config
    with _TUNED_LOCK:
        _TUNED = table
        _TUNED_SOURCE = None if mapping is None else dict(source or {})


def tuned_config(bucket, default: LaunchConfig | None = DEFAULT_CONFIG) -> LaunchConfig | None:
    """The installed config of ``bucket``, or ``default``."""
    with _TUNED_LOCK:
        return _TUNED.get(tuple(bucket), default)


def tuned_summary() -> dict | None:
    """Provenance of the installed record (``None`` when none is)."""
    with _TUNED_LOCK:
        if _TUNED_SOURCE is None:
            return None
        return {**_TUNED_SOURCE, "entries": len(_TUNED)}
