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

The library builds at first use (``ops/_build.py``). Right after it loads,
the K4 probe runs once as a self-check and the load fails unless it reads 3.

A launch costs the host a few microseconds, and K3 alone makes 15 a level,
so the launch path does no more than it must: ``_validate`` reads tensor
attributes and builds no ``torch.device``; the stream is the raw handle of
the device's current stream, read with ``_current_stream`` and never built
into a ``torch.cuda.Stream``; one call into the extension module launches
(``csrc/bindings.cpp``, cheaper than ``ctypes``), and the C launcher sets
the device only where it is not already current.
"""

from __future__ import annotations

import math

import torch

from distributed_ghs_implementation_tpu_torch.ops import _build

INT32_MAX = 2**31 - 1

_LIB = None
#: ``torch._C._cuda_getCurrentRawStream``: the raw handle of a device's
#: current stream, read without building a ``torch.cuda.Stream`` object.
#: Bound by ``_lib()``; CPU builds of torch do not have it.
_current_stream = None


def _lib():
    """The loaded kernel library; the first call builds, loads and runs the
    probe self-check."""
    global _LIB, _current_stream
    if _LIB is None:
        raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)
        if raw_stream is None:
            raise RuntimeError(
                "this build of torch has no torch._C._cuda_getCurrentRawStream; "
                "the kernels need a CUDA build of torch"
            )
        _current_stream = raw_stream
        lib = _build.load_library()
        table = torch.arange(256, dtype=torch.int32, device="cuda")
        idx = torch.full((2, 128), 3, dtype=torch.int32, device="cuda")
        out = torch.empty_like(idx)
        _launch_probe(lib, table.get_device(), table, idx, out, idx.numel())
        if not bool((out == 3).all()):
            raise RuntimeError(f"kernel self-check read {out.unique().tolist()}, not [3]")
        _LIB = lib
    return _LIB


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


def hook_compress(has_moe, moe_dst_frag, fragment):
    """K1: one merge round, the contract of ``union_find.hook_and_compress``.
    Replaces ``fused_hook_compress`` (JAX package
    ``ops/pallas_kernels.py:516``)."""
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
        scratch = torch.empty_like(fragment)
        lib = _lib()
        code = lib.hook_compress(
            device, has_moe.data_ptr(), moe_dst_frag.data_ptr(), fragment.data_ptr(),
            new_fragment.data_ptr(), parent.data_ptr(), scratch.data_ptr(), n,
            num_jumps(n), _current_stream(device),
        )
        if code:
            _fail("hook_compress", lib, code)
        hook_compress.launches += 1
    return new_fragment, parent


hook_compress.launches = 0


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


def ell_row_min(fragment, verts, dstb, rankb):
    """K3: one ELL bucket's masked row minimum. Replaces
    ``fused_ell_row_min`` (JAX package ``ops/pallas_kernels.py:465``)."""
    if fragment.is_cpu:
        return ell_row_min_torch(fragment, verts, dstb, rankb)
    device = _validate("ell_row_min", {
        "fragment": fragment, "verts": verts, "dstb": dstb, "rankb": rankb,
    })
    if (fragment.dim() != 1 or verts.dim() != 1 or dstb.dim() != 2 or dstb.shape[1] < 1
            or dstb.shape != rankb.shape or dstb.shape[0] != verts.shape[0]):
        raise ValueError(
            f"ell_row_min: want fragment[n], verts[rows] and dstb/rankb[rows, W >= 1], got "
            f"{tuple(fragment.shape)}, {tuple(verts.shape)}, {tuple(dstb.shape)}, "
            f"{tuple(rankb.shape)}"
        )
    rows, width = dstb.shape
    out = torch.empty_like(verts)
    if rows:
        lib = _lib()
        code = lib.ell_row_min(
            device, fragment.data_ptr(), verts.data_ptr(), dstb.data_ptr(),
            rankb.data_ptr(), out.data_ptr(), rows, width, _current_stream(device),
        )
        if code:
            _fail("ell_row_min", lib, code)
        ell_row_min.launches += 1
    return out


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

#: Every kernel wrapper, for code that reads or resets the launch counts.
WRAPPERS = (gather_key, hook_compress, probe, ell_row_min, gather)
