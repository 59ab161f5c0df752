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

#: The wrapper that counts each kernel's launches, for code that reads or
#: resets the counts.
WRAPPERS = (gather_key, hook_compress, probe, ell_row_min, gather)


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
