"""Parity of the PyTorch port's ops and kernel plain versions with the JAX
package, element-exact (all state is integer: tolerance 0).

The port runs on the CPU (``device="cpu"``), which means its plain PyTorch
versions. The JAX side runs on the CPU as the JAX tests run it; its Pallas
kernels in interpret mode, called directly on shapes that pass their guards.
``tests/test_torch_cuda.py`` holds the CUDA kernels against the plain
versions on a card.
"""

import re
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

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
from distributed_ghs_implementation_tpu_torch import device as tdevice
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


@pytest.mark.parametrize("n", [128, 1024])
@pytest.mark.parametrize("kind", ["none", "cycle"])
def test_hook_compress_on_inputs_no_round_gives_matches_pallas(n, kind):
    """Nothing hooked, and every node hooked around one cycle (garbage that
    never reaches a fixpoint): the plain version runs the same fixed
    ``num_jumps(n)`` jumps as the Pallas kernel, in every form. (At n off
    the 128-lane grid the Pallas kernel jumps as often as its padded size
    asks, which only garbage can tell apart.)"""
    has, dst, frag = _hook_forest(n, n, kind)
    want = pk.fused_hook_compress(*(jnp.asarray(a) for a in (has, dst, frag)))
    args = [_t(a) for a in (has, dst, frag)]
    for form in kernels.HOOK_FORMS:
        got = kernels.hook_compress(*args, form=form)
        _eq(got[0], want[0])
        _eq(got[1], want[1])
    if kind == "none":
        _eq(want[1], np.arange(n))


def test_hook_compress_refuses_an_unknown_form():
    args = [_t(a) for a in _hook_forest(0, 10, "random")]
    with pytest.raises(ValueError, match="form must be one of"):
        kernels.hook_compress(*args, form="warp")


def test_hook_block_limits_match_the_launcher():
    """The wrapper's copy of the block form's limits is the launcher's."""
    text = (_build.SOURCES[0].parent / "hook_compress.cu").read_text()
    env = {}
    for name, expr in re.findall(r"constexpr long long (k\w+) = ([^;]+);", text):
        env[name] = eval(expr.replace("/", "//"), {}, env)
    assert env["kBlockMaxNodes"] == kernels.HOOK_BLOCK_MAX_NODES
    assert env["kBlockFormThreshold"] == kernels.HOOK_BLOCK_FORM_THRESHOLD
    assert kernels.HOOK_BLOCK_FORM_THRESHOLD <= kernels.HOOK_BLOCK_MAX_NODES
    assert 8 * kernels.HOOK_BLOCK_MAX_NODES <= 232448  # two int32 buffers in 227 KB


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


def _meta_args(name):
    meta = torch.empty(8, dtype=torch.int32, device="meta")
    return {
        "gather_key": (meta, meta, meta, meta),
        "hook_compress": (torch.empty(8, dtype=torch.bool, device="meta"), meta, meta),
        "probe": (meta, meta),
        "ell_row_min": (meta, meta, meta.view(2, 4), meta.view(2, 4)),
        "gather": (meta, meta),
    }[name]


@pytest.mark.parametrize("name", [w.__name__ for w in kernels.WRAPPERS])
def test_every_wrapper_refuses_meta_tensors(name):
    before = [w.launches for w in kernels.WRAPPERS]
    with pytest.raises(ValueError, match="CUDA or CPU"):
        getattr(kernels, name)(*_meta_args(name))
    assert [w.launches for w in kernels.WRAPPERS] == before


def _fake_cuda(dtype=torch.int32, device=0, contiguous=True):
    """What ``_validate`` reads of a CUDA tensor, without a card."""
    return SimpleNamespace(is_cuda=True, dtype=dtype, get_device=lambda: device,
                           is_contiguous=lambda: contiguous, device=f"cuda:{device}")


@pytest.mark.parametrize("tensors,dtypes,error,match", [
    ({"a": _fake_cuda(), "b": _fake_cuda(torch.int64)}, None, TypeError, "b must be torch.int32"),
    ({"a": _fake_cuda(), "b": _fake_cuda(contiguous=False)}, None, ValueError, "contiguous"),
    ({"a": _fake_cuda(), "b": _fake_cuda(device=1)}, None, ValueError, "several devices"),
    ({"a": _fake_cuda(), "b": torch.zeros(2, dtype=torch.int32)}, None, ValueError,
     "CUDA or CPU"),
    ({"a": _fake_cuda(torch.int32)}, {"a": torch.bool}, TypeError, "a must be torch.bool"),
])
def test_validate_refuses_each_fault(tensors, dtypes, error, match):
    with pytest.raises(error, match=match):
        kernels._validate("k", tensors, dtypes)


def test_validate_returns_the_device_index():
    tensors = {"has": _fake_cuda(torch.bool, device=2), "f": _fake_cuda(device=2)}
    assert kernels._validate("k", tensors, {"has": torch.bool}) == 2


def test_lib_needs_the_raw_stream_getter_before_it_builds(monkeypatch):
    """A CPU build of torch has no ``torch._C._cuda_getCurrentRawStream``:
    loading the kernels says so, and builds nothing."""
    monkeypatch.delattr(torch._C, "_cuda_getCurrentRawStream", raising=False)
    monkeypatch.setattr(_build, "load_library", lambda: pytest.fail("built without a stream"))
    monkeypatch.setattr(kernels, "_LIB", None)
    with pytest.raises(RuntimeError, match="_cuda_getCurrentRawStream"):
        kernels._lib()
    assert kernels._LIB is None


def test_lib_loads_once_for_threads_that_come_together(monkeypatch):
    """Eight threads reach the first load at once: one builds, loads and
    self-checks the library, the others wait and reuse it."""
    loads, checks, gate = [], [], threading.Barrier(8)

    def slow_load():
        loads.append(threading.get_ident())
        time.sleep(0.05)  # wide enough for the others to arrive
        return SimpleNamespace(name="lib")

    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda d: 0, raising=False)
    monkeypatch.setattr(_build, "load_library", slow_load)
    monkeypatch.setattr(kernels, "_self_check", checks.append)
    monkeypatch.setattr(kernels, "_LIB", None)
    got = []

    def first_use():
        gate.wait(timeout=30)
        got.append(kernels._lib())

    threads = [threading.Thread(target=first_use) for _ in range(8)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert len(loads) == 1 and len(checks) == 1
    assert len(got) == 8 and all(lib is got[0] for lib in got)
    assert checks[0] is got[0] is kernels._LIB


def test_importing_kernels_touches_no_cuda_only_binding():
    """Importing the kernel module, with JAX blocked, reads no ``_cuda*``
    attribute of ``torch._C`` and leaves CUDA uninitialised."""
    code = (
        "import sys, types\n"
        "sys.modules['jax'] = None\n"
        "import torch\n"
        "seen = []\n"
        "class Spy(types.ModuleType):\n"
        "    def __getattribute__(self, name):\n"
        "        if name.startswith('_cuda'):\n"
        "            seen.append(name)\n"
        "        return getattr(real, name)\n"
        "real = torch._C\n"
        "torch._C = Spy('torch._C')\n"
        "from distributed_ghs_implementation_tpu_torch.ops import kernels\n"
        "torch._C = real\n"
        "assert not seen, seen\n"
        "assert kernels._LIB is None and kernels._current_stream is None\n"
        "assert not torch.cuda.is_initialized()\n"
        "assert 'jax' not in [m.split('.')[0] for m in sys.modules if sys.modules[m]]\n"
        "print('ok')\n"
    )
    repo = Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=repo)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


class _FakeEvent:
    """A CUDA event whose times come from a script: the n-th timed window
    lasts ``durations[n]`` ms in all."""

    log: list = []
    durations: list = []

    def __init__(self, enable_timing=False):
        pass

    def record(self):
        pass

    def elapsed_time(self, end):
        return _FakeEvent.durations[(len(_FakeEvent.log) - 2) // 10 - 1]


def test_cuda_time_in_turns_alternates_abba_and_reports_medians(monkeypatch):
    _FakeEvent.log = []
    # Four rounds give the windows a, b, b, a, a, b, b, a: a takes 10 ms a
    # window of 10 calls except one of 30, b 20 ms except one of 40.
    _FakeEvent.durations = [10, 20, 20, 10, 30, 40, 20, 10]
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    got = tdevice.cuda_time_in_turns_ms(lambda: _FakeEvent.log.append("a"),
                                        lambda: _FakeEvent.log.append("b"), reps=4, iters=10)
    calls = "".join(_FakeEvent.log)
    assert calls[:2] == "ab"  # one warm-up call of each
    assert calls[2:] == "".join(c * 10 for c in "abbaabba")
    assert got["a_ms"] == 1.0 and got["b_ms"] == 2.0
    assert got["a_spread_ms"] == pytest.approx(2.0) and got["b_spread_ms"] == pytest.approx(2.0)


@pytest.mark.parametrize("part", ["HEADERS", "BINDING"])
def test_build_cache_key_covers_the_header_and_the_binding(monkeypatch, part):
    assert {p.name for p in _build.HEADERS} == {"launch.cuh"}
    assert _build.BINDING.is_file() and _build.BINDING not in _build.SOURCES
    key = _build.cache_key()
    monkeypatch.setattr(_build, part, () if part == "HEADERS" else _build.SOURCES[0])
    assert _build.cache_key() != key


def test_build_without_python_headers_says_so(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.sysconfig, "get_paths", lambda: {"include": str(tmp_path)})
    with pytest.raises(RuntimeError, match="Python.h not found"):
        _build._python_include()


#: C launchers that stand in for the CUDA ones: each returns a hash of its
#: arguments, so the test can see that the binding passed them unchanged.
_STUB_LAUNCHERS = r"""
#include <stdint.h>
#include <stdio.h>
#define H(x) ((uint64_t)(uintptr_t)(x))
static int mix(uint64_t h) { return (int)((h ^ (h >> 31)) & 0x7fffffff); }
int ghs_gather_key(int d, const void* a, const void* b, const void* c, const void* e,
                   void* f, void* g, long long n, void* s) {
  return mix(11 * d + 3 * H(a) + 5 * H(b) + 7 * H(c) + 13 * H(e) + 17 * H(f) + 19 * H(g) +
             23 * (uint64_t)n + 29 * H(s));
}
int ghs_hook_compress(int d, const void* a, const void* b, const void* c, void* e, void* f,
                      void* g, long long n, int j, int form, void* s) {
  return mix(11 * d + 3 * H(a) + 5 * H(b) + 7 * H(c) + 13 * H(e) + 17 * H(f) + 19 * H(g) +
             23 * (uint64_t)n + 31 * (uint64_t)j + 37 * (uint64_t)form + 29 * H(s));
}
int ghs_probe(int d, const void* a, const void* b, void* c, long long n, void* s) {
  return mix(11 * d + 3 * H(a) + 5 * H(b) + 7 * H(c) + 23 * (uint64_t)n + 29 * H(s));
}
int ghs_ell_level(int d, const void* a, void* b, const void* c, long long count,
                  long long tiles, int row_indexed, void* s) {
  return mix(11 * d + 3 * H(a) + 5 * H(b) + 7 * H(c) + 23 * (uint64_t)count +
             31 * (uint64_t)tiles + 37 * (uint64_t)row_indexed + 29 * H(s));
}
int ghs_gather(int d, const void* a, const void* b, void* c, long long n, void* s) {
  return mix(11 * d + 3 * H(a) + 5 * H(b) + 7 * H(c) + 23 * (uint64_t)n + 29 * H(s));
}
static char message[64];
const char* ghs_error_string(int code) {
  snprintf(message, sizeof message, "stub error %d", code);
  return message;
}
"""


def _mix(*terms):
    h = sum(terms) % (1 << 64)
    return (h ^ (h >> 31)) & 0x7FFFFFFF


@pytest.fixture(scope="module")
def stub_binding(tmp_path_factory):
    """The real ``bindings.cpp`` built with the host compiler against the
    stub launchers, as ``_build`` names the module."""
    import shutil
    import sysconfig

    include = sysconfig.get_paths()["include"]
    cxx = shutil.which("g++")
    if cxx is None or not (Path(include) / "Python.h").is_file():
        pytest.skip("needs g++ and Python.h to build the binding on the host")
    tmp = tmp_path_factory.mktemp("binding")
    stub = tmp / "stubs.c"
    stub.write_text(_STUB_LAUNCHERS)
    subprocess.run(["gcc", "-O1", "-fPIC", "-c", str(stub), "-o", str(tmp / "stubs.o")],
                   check=True, capture_output=True)
    so = tmp / _build.LIB_NAME
    subprocess.run([cxx, "-O1", "-std=c++17", "-fPIC", "-shared", f"-I{include}",
                    str(_build.BINDING), str(tmp / "stubs.o"), "-o", str(so)],
                   check=True, capture_output=True)
    return so


def test_binding_passes_each_launcher_its_arguments(monkeypatch, stub_binding):
    monkeypatch.setattr(_build, "build_library", lambda: stub_binding)
    mod = _build.load_library()
    ptr = [(1 << 47) - 4096 * k for k in range(1, 8)]  # user-space pointers, as data_ptr() gives
    stream, big = (1 << 46) + 8, (1 << 33) + 5
    h = lambda *ps: [c * p for c, p in zip((3, 5, 7, 13, 17, 19), ps)]  # noqa: E731
    assert mod.gather_key(1, *ptr[:6], big, stream) == _mix(11, *h(*ptr[:6]), 23 * big,
                                                           29 * stream)
    for form in (0, 1, 2):
        assert mod.hook_compress(0, *ptr[:6], 1 << 18, 18, form, stream) == _mix(
            *h(*ptr[:6]), 23 << 18, 31 * 18, 37 * form, 29 * stream)
    for fn in (mod.probe, mod.gather):
        assert fn(2, *ptr[:3], big, 0) == _mix(22, *h(*ptr[:3]), 23 * big)
    for row_indexed in (0, 1):
        assert mod.ell_level(0, *ptr[:3], 15, 4203, row_indexed, stream) == _mix(
            *h(*ptr[:3]), 23 * 15, 31 * 4203, 37 * row_indexed, 29 * stream)
    assert mod.error_string(700) == "stub error 700"
    with pytest.raises(RuntimeError, match=r"launch failed: CUDA error 9 \(stub error 9\)"):
        kernels._fail("probe", mod, 9)
    with pytest.raises(TypeError, match="probe takes 6 arguments, got 2"):
        mod.probe(0, 1)
    with pytest.raises(TypeError):
        mod.gather(0, 1, 2, 3, "4", 5)


@pytest.mark.parametrize("source", [p.name for p in _build.SOURCES])
def test_every_launcher_sets_the_device_through_the_guard(source):
    """No launcher calls ``cudaSetDevice`` itself (the guard sets it only
    where it differs and puts it back); none sets device-wide cache state."""
    text = (Path(_build.SOURCES[0]).parent / source).read_text()
    assert text.count('extern "C" int ghs_') == text.count("ghs::DeviceGuard guard(device)")
    assert "cudaSetDevice" not in text
    assert "cudaLimitPersistingL2CacheSize" not in text and "accessPolicyWindow" not in text


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
