"""Parity of the PyTorch port's ops and kernel plain versions with the JAX
package, element-exact (all state is integer: tolerance 0).

The port runs on the CPU (``device="cpu"``), which means its plain PyTorch
versions. The JAX side runs on the CPU as the JAX tests run it; its Pallas
kernels in interpret mode, called directly on shapes that pass their guards.
``tests/test_torch_cuda.py`` holds the CUDA kernels against the plain
versions on a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributed_ghs_implementation_tpu.graphs.generators import gnm_random_graph
from distributed_ghs_implementation_tpu.models.boruvka import (
    prepare_device_arrays as jax_prepare,
)
from distributed_ghs_implementation_tpu.ops import pallas_kernels as pk
from distributed_ghs_implementation_tpu.ops import segment_ops as jseg
from distributed_ghs_implementation_tpu.ops import union_find as juf
from distributed_ghs_implementation_tpu_torch.ops import _build, kernels
from distributed_ghs_implementation_tpu_torch.ops import segment_ops as tseg
from distributed_ghs_implementation_tpu_torch.ops import union_find as tuf
from torch_inputs import FLAT_SHAPES, hook_forest as _hook_forest, moe_inputs as _moe_inputs

INT32_MAX = np.iinfo(np.int32).max


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# ---------------------------------------------------------------------------
# K2 gather_key and fragment_moe
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,e", FLAT_SHAPES)
def test_gather_key_matches_pallas_kernel(n, e):
    fragment, src, dst, rank, _, _ = _moe_inputs(n + e, n, e)
    assert pk.flat_shape_ok(n, e)
    want = pk.fused_gather_key(*(jnp.asarray(a) for a in (fragment, src, dst, rank)))
    args = [_t(a) for a in (fragment, src, dst, rank)]
    for got in (kernels.gather_key_torch(*args), kernels.gather_key(*args)):
        _eq(got[0], want[0])
        _eq(got[1], want[1])


@pytest.mark.parametrize("n,e", FLAT_SHAPES + [(50, 999), (3, 2)])
@pytest.mark.parametrize("identity", [False, True])
def test_fragment_moe_matches_jax(n, e, identity):
    fragment, src, dst, rank, ra, rb = _moe_inputs(7 * n + e, n, e)
    if identity:
        fragment = np.arange(n, dtype=np.int32)
    got = tseg.fragment_moe(*(_t(a) for a in (fragment, src, dst, rank, ra, rb)),
                            identity_fragment=identity)
    jargs = [jnp.asarray(a) for a in (fragment, src, dst, rank, ra, rb)]
    kernels_to_check = ["xla"] + (["pallas"] if pk.flat_shape_ok(n, e) else [])
    for kernel in kernels_to_check:
        want = jseg.fragment_moe(*jargs, identity_fragment=identity, kernel=kernel)
        for g, w in zip(got, want):
            _eq(g, w)


def test_segment_min_empty_segments_read_int32_max():
    data = _t(np.array([5, 3, 9, 1], dtype=np.int32))
    ids = _t(np.array([0, 0, 2, 2], dtype=np.int32))
    got = tseg.segment_min(data, ids, 4)
    _eq(got, [3, INT32_MAX, 1, INT32_MAX])
    _eq(got, jseg.segment_min(jnp.asarray(data.numpy()), jnp.asarray(ids.numpy()), 4))
    assert tseg.weight_sentinel(torch.int32) == INT32_MAX
    assert tseg.weight_sentinel(torch.float32) == float("inf")


# ---------------------------------------------------------------------------
# K1 hook_compress and the union-find ops
# ---------------------------------------------------------------------------
def _check_hook(has, dst, frag):
    jargs = [jnp.asarray(a) for a in (has, dst, frag)]
    want_pallas = pk.fused_hook_compress(*jargs)
    want_xla = juf.hook_and_compress(*jargs, kernel="xla")
    args = [_t(a) for a in (has, dst, frag)]
    for got in (
        kernels.hook_compress_torch(*args),
        kernels.hook_compress(*args),
        tuf.hook_and_compress(*args),
    ):
        for want in (want_pallas, want_xla):
            _eq(got[0], want[0])
            _eq(got[1], want[1])


@pytest.mark.parametrize("n", [1, 2, 127, 128, 129, 5000])
@pytest.mark.parametrize("kind", ["random", "star"])
def test_hook_compress_matches_pallas_and_xla(n, kind):
    assert pk.hook_shape_ok(n)
    _check_hook(*_hook_forest(n, n, kind))


def test_hook_compress_deep_chain():
    """A path of 2^12 nodes: depth 4095, which the fixed 12 jumps and the
    early-exit loop both compress to one root."""
    n = 1 << 12
    has, dst, frag = _hook_forest(0, n, "chain")
    _check_hook(has, dst, frag)
    parent = _t(np.where(has, dst, np.arange(n)).astype(np.int32))
    early = tuf.pointer_jump(parent)
    fixed = tuf.pointer_jump(parent, num_iters=kernels.num_jumps(n))
    _eq(early, fixed)
    _eq(early, np.zeros(n, dtype=np.int32))
    _eq(fixed, juf.pointer_jump(jnp.asarray(parent.numpy()), num_iters=kernels.num_jumps(n)))


@pytest.mark.parametrize("n", [1000, 1024])
def test_hook_compress_on_a_real_moe_round(n):
    g = gnm_random_graph(n, 4 * n, seed=n)
    fragment0, src, dst, rank, ra, rb = jax_prepare(g, bucket_shapes=False)
    has, _, dst_frag = jseg.fragment_moe(fragment0, src, dst, rank, ra, rb)
    _check_hook(np.asarray(has), np.asarray(dst_frag), np.asarray(fragment0))


def test_break_symmetric_hooks_matches_jax():
    has, dst, _ = _hook_forest(3, 300, "random")
    parent = np.where(has, dst, np.arange(300)).astype(np.int32)
    _eq(tuf.break_symmetric_hooks(_t(parent)), juf.break_symmetric_hooks(jnp.asarray(parent)))


@pytest.mark.parametrize("n", [1, 2, 3, 5, 128, 1 << 10, (1 << 10) + 1, 5120])
def test_num_jumps_reaches_every_root(n):
    """2^jumps covers the deepest chain a forest of n nodes holds (n - 1);
    at lane-aligned n it is the TPU kernel's own count."""
    j = kernels.num_jumps(n)
    assert 2 ** j >= n - 1
    if n % 128 == 0:
        assert j == max(1, int(np.ceil(np.log2(max(2, n)))))


# ---------------------------------------------------------------------------
# K4 probe, wrappers and the build
# ---------------------------------------------------------------------------
def test_probe_plain_version_reads_three():
    table = torch.arange(256, dtype=torch.int32)
    idx = torch.full((2, 128), 3, dtype=torch.int32)
    got = kernels.probe(table, idx)
    assert got.shape == (2, 128) and bool((got == 3).all())
    _eq(got, kernels.probe_torch(table, idx))


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    before = [w.launches for w in kernels.WRAPPERS]
    fragment, src, dst, rank, _, _ = _moe_inputs(0, 10, 64)
    kernels.gather_key(*(_t(a) for a in (fragment, src, dst, rank)))
    kernels.hook_compress(*(_t(a) for a in _hook_forest(0, 10, "random")))
    assert [w.launches for w in kernels.WRAPPERS] == before


def test_wrappers_refuse_devices_they_have_no_kernel_for():
    """Off the CPU a wrapper launches its kernel or raises; a tensor on
    another device never falls back to the plain version."""
    meta = torch.empty(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kernels.gather_key(meta, meta, meta, meta)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kernels.hook_compress(torch.empty(8, dtype=torch.bool, device="meta"), meta, meta)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kernels.probe(meta, meta)


def test_build_without_nvcc_says_so(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda _name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_library()


def test_build_cache_key_covers_every_source():
    names = {p.name for p in _build.SOURCES}
    assert names == {"ell_row_min.cu", "gather.cu", "gather_key.cu", "hook_compress.cu",
                     "probe.cu"}
    assert _build.library_path().parent.name == _build.cache_key()
    assert _build.library_path().is_relative_to(_build.BUILD_ROOT)
