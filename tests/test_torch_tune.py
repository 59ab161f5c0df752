"""The port's launch-config tuner (``tune/``), its install path and the
port's build cache (``utils/compile_cache.py``), on the CPU.

Mirrors the JAX package's ``tests/test_tune.py`` where the rule is the same:
enumeration is pure and guarded, a dry or CPU search is pinned and
byte-reproducible, the ``ghs-tuning-v1`` record round-trips with its
integrity sidecar, and a missing, stale or corrupt record installs nothing
and is counted. Where the port differs it is pinned: a candidate is the
device's kernel label (``torch`` here) and a ``kernels.LaunchConfig`` (K1's
form, K3's tile), the parity gate holds every candidate's forest to the
default config's, and a record fingerprints the card, its NVIDIA
software, CUDA and torch, so a record the JAX package wrote is stale here. The build cache's
counters are checked on the native library's ``g++`` build, which runs
here; the CUDA library's ``nvcc`` build runs only on the card.
"""

import json
import os

import numpy as np
import pytest

from distributed_ghs_implementation_tpu.batch import warmup as jwarmup
from distributed_ghs_implementation_tpu.ops import pallas_kernels as jpk
from distributed_ghs_implementation_tpu.tune import measure as jmeasure
from distributed_ghs_implementation_tpu.tune import record as jrecord
from distributed_ghs_implementation_tpu_torch.batch import lanes as tlanes
from distributed_ghs_implementation_tpu_torch.batch import warmup as twarmup
from distributed_ghs_implementation_tpu_torch.graphs import generators as tgen
from distributed_ghs_implementation_tpu_torch.graphs import native
from distributed_ghs_implementation_tpu_torch.models import boruvka as tb
from distributed_ghs_implementation_tpu_torch.obs.events import BUS
from distributed_ghs_implementation_tpu_torch.ops import _build, kernels
from distributed_ghs_implementation_tpu_torch.ops._build import KernelBuildError
from distributed_ghs_implementation_tpu_torch.tune import measure, record, space
from distributed_ghs_implementation_tpu_torch.tune.record import (
    TuningRecordError,
    install_record,
    load_and_install,
    load_record,
    save_record,
)
from distributed_ghs_implementation_tpu_torch.utils import compile_cache
from torch_pairs import CPU, isolated  # noqa: F401 -- fixture

pytestmark = pytest.mark.usefixtures("isolated", "clean_state")

BUCKETS = [(64, 256, 2, "fused"), (64, 256, 0, "fused")]


@pytest.fixture
def clean_state(monkeypatch):
    """No installed record, no solver built, cleared buses, in both
    packages."""
    monkeypatch.delenv("GHS_KERNEL", raising=False)
    jpk._reset_for_tests()
    kernels.set_tuned_configs(None)
    tlanes.clear_solver_cache()
    BUS.clear()
    yield
    jpk._reset_for_tests()
    kernels.set_tuned_configs(None)
    tlanes.clear_solver_cache()


def _search(buckets=BUCKETS, **kw):
    return measure.search(buckets, dry=True, device=CPU, **kw)


# ----------------------------------------------------------------------
# tune/space.py
# ----------------------------------------------------------------------
@pytest.mark.parametrize("bucket", [(128, 512, 16, "fused"), (8192, 131072, 16, "fused"),
                                    (256, 1024, 4, "vmap"), (262144, 4194304, 0, "ell"),
                                    (1024, 4096, 0, "ell"), (4096, 8192, 4, "mesh")])
def test_enumeration_default_first_deterministic_and_guarded(bucket):
    a = space.enumerate_candidates(*bucket, kernel="torch")
    assert a == space.enumerate_candidates(*bucket, kernel="torch")
    assert a[0] == space.Candidate("torch") and a[0].config == kernels.DEFAULT_CONFIG
    assert len({c.label() for c in a}) == len(a) <= space.raw_space_size(bucket[3])
    assert all(c.kernel == "torch" and space.candidate_valid(c.config, *bucket) for c in a)
    assert not {c.kernel for c in a} & {"pallas", "xla"}
    nodes = space.bucket_nodes(bucket[0], bucket[2], bucket[3])
    forms = {c.config.hook_form for c in a}
    assert ("block" in forms) == (nodes <= kernels.HOOK_BLOCK_MAX_NODES)
    tiles = {c.config.tile_slots for c in a}
    assert tiles == (set(space.TILE_SLOT_CHOICES) if bucket[3] == "ell"
                     else {kernels.ELL_TILE_SLOTS})


def test_the_lane_stack_sets_the_block_guard():
    """The port's fused and vmap lanes both run one stack of lanes * n_pad
    nodes; a single graph and a mesh's proxy run n_pad."""
    assert space.bucket_nodes(128, 16, "fused") == space.bucket_nodes(128, 16, "vmap") == 2048
    assert space.bucket_nodes(65536, 0, "fused") == space.bucket_nodes(65536, 8, "mesh") == 65536
    big = kernels.LaunchConfig("block", kernels.ELL_TILE_SLOTS)
    assert space.candidate_valid(big, 1024, 4096, 16, "fused")  # 16,384 nodes
    assert not space.candidate_valid(big, 2048, 4096, 16, "fused")  # 32,768 nodes
    assert not space.candidate_valid(kernels.LaunchConfig("auto", 4096), 64, 256, 2, "fused")


def test_bad_buckets_raise_and_normalize_dedupes_and_sorts():
    with pytest.raises(ValueError, match="mode"):
        space.enumerate_candidates(64, 256, 2, "warp")
    with pytest.raises(ValueError, match="sizes"):
        space.enumerate_candidates(0, 256, 2, "fused")
    with pytest.raises(ValueError):
        measure.normalize_buckets([(64, 256, 2, "warp")])
    got = measure.normalize_buckets([(256, 1024, 4, "fused"), (64, 256, 0, "fused"),
                                     (256, 1024, 4, "fused")])
    assert got == jmeasure.normalize_buckets([(256, 1024, 4, "fused"), (64, 256, 0, "fused"),
                                              (256, 1024, 4, "fused")])
    assert got == [(64, 256, 0, "fused"), (256, 1024, 4, "fused")]


@pytest.mark.parametrize("args", [(70_000, 140_000, 8), (2000, 6000, 4), (1, 1, 1)])
def test_mesh_bucket_and_seeded_graph_equal_jax(args):
    assert measure.mesh_bucket(*args) == jmeasure.mesh_bucket(*args)
    n_pad, m_pad = tlanes.bucket_of(args[0], args[1])
    t, j = measure._bucket_graph(n_pad, m_pad, 24), jmeasure._bucket_graph(n_pad, m_pad, 24)
    assert (t is None) == (j is None)
    if t is not None:
        for a in "uvw":
            np.testing.assert_array_equal(getattr(t, a), getattr(j, a))


# ----------------------------------------------------------------------
# tune/measure.py
# ----------------------------------------------------------------------
def test_dry_search_is_deterministic_and_the_cpu_pins_torch():
    a, b = _search(), _search()
    assert a == b and a["pinned"] is True
    want = jmeasure.search(BUCKETS, dry=True)
    assert set(a["entries"]) == set(want["entries"])
    for key, entry in a["entries"].items():
        assert entry["kernel"] == "torch" and entry["source"] == "cpu-pin"
        assert entry["config"] == kernels.DEFAULT_CONFIG.to_json()
        assert (entry["source"], entry["parity"]) == (want["entries"][key]["source"],
                                                      want["entries"][key]["parity"])
    assert BUS.counters()["tune.search.candidate"] == 2 * 3 * len(BUCKETS)
    # A non-dry search on the CPU pins too.
    assert measure.search(BUCKETS, device=CPU) == a


def test_unreachable_bucket_keeps_the_default_as_in_jax():
    entry = _search([(4, 1024, 0, "fused")])["entries"]["4x1024x0xfused"]
    assert entry["source"] == "unreachable" == jmeasure.search(
        [(4, 1024, 0, "fused")], dry=True)["entries"]["4x1024x0xfused"]["source"]
    assert entry["config"] == kernels.DEFAULT_CONFIG.to_json()


def test_every_mode_runs_its_solver_and_passes_parity():
    rec = _search([(64, 256, 2, "fused"), (64, 256, 2, "vmap"), (64, 256, 0, "ell"),
                   (64, 256, 2, "mesh")])
    assert all(e["parity"] == "ok" for e in rec["entries"].values())


def test_workloads_replace_the_seeded_graph_and_must_fit_the_bucket():
    g = tgen.rmat_graph(9, 8, seed=1)
    bucket = (*tlanes.bucket_key(g), 0, "ell")
    seen = []
    real = measure._make_runner

    def spy(b, cand, graph, device):
        seen.append(graph)
        return real(b, cand, graph, device)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(measure, "_make_runner", spy)
        _search([bucket], workloads={bucket: g})
    assert seen and all(x is g for x in seen)
    with pytest.raises(ValueError, match="pads into"):
        _search([(64, 256, 0, "ell")], workloads={(64, 256, 0, "ell"): g})


def _wrong_for(label):
    """A runner factory whose candidate ``label`` returns a forest with one
    edge more."""
    real = measure._make_runner

    def make(bucket, cand, graph, device):
        run = real(bucket, cand, graph, device)
        if cand.label() != label:
            return run

        def wrong():
            mst, frag, levels = run()
            mst = mst.clone()
            mst[np.flatnonzero(mst.numpy() == 0)[0]] = 1
            return mst, frag, levels
        return wrong
    return make


def test_the_parity_gate_rejects_a_wrong_forest_when_pinned(monkeypatch):
    bucket = (128, 512, 4, "fused")
    second = space.enumerate_candidates(*bucket, kernel="torch")[1].label()
    monkeypatch.setattr(measure, "_make_runner", _wrong_for(second))
    entry = _search([bucket])["entries"]["128x512x4xfused"]
    assert entry["parity"] == "failed" and entry["rejected"] == 1
    assert entry["config"] == kernels.DEFAULT_CONFIG.to_json()
    assert BUS.counters()["tune.search.rejected"] == 1


def test_the_parity_gate_rejects_the_fastest_candidate_if_its_forest_differs(monkeypatch):
    """Unpinned (as on the card), with times made up so that the wrong
    candidate is the fastest: it is scored dead and never timed, and the
    fastest candidate that passed wins."""
    bucket = (128, 512, 4, "fused")
    cands = space.enumerate_candidates(*bucket, kernel="torch")
    assert [c.config.hook_form for c in cands] == ["auto", "block", "grid"]
    monkeypatch.setattr(measure, "_make_runner", _wrong_for(cands[1].label()))
    monkeypatch.setattr(measure, "_pin", lambda device, dry: (False, None))
    times = {"auto": 3.0, "block": 1.0, "grid": 2.0}
    timed = []
    real = measure._make_runner

    def labelled(b, cand, graph, device):
        inner = real(b, cand, graph, device)

        def run():
            return inner()
        run.form = cand.config.hook_form
        return run

    def fake_time(run):
        timed.append(run.form)
        return times[run.form]

    monkeypatch.setattr(measure, "_make_runner", labelled)
    monkeypatch.setattr(measure, "_time_ms", fake_time)
    entry = measure.search([bucket], device=CPU, repeats=3, warm=2)["entries"]["128x512x4xfused"]
    # One untimed warm round (auto, grid), then three timed rounds in turns.
    assert timed == ["grid", "auto", "auto", "grid", "grid", "auto"]
    assert entry["source"] == "measured" and entry["parity"] == "failed"
    assert entry["config"]["hook_form"] == "grid" and entry["median_s"] == 0.002
    assert entry["runner_up_s"] == 0.003 and entry["rejected"] == 1
    assert set(entry["timings"]) == {cands[0].label(), cands[2].label()}
    assert entry["timings"][cands[2].label()] == {"median_ms": 2.0, "spread_ms": 0.0}


def test_a_failing_candidate_is_dead_and_a_failing_default_leaves_no_survivor(monkeypatch):
    bucket = (128, 512, 4, "fused")
    real = measure._make_runner
    cands = space.enumerate_candidates(*bucket, kernel="torch")

    def bomb_on(label):
        def make(b, cand, graph, device):
            if cand.label() == label:
                raise RuntimeError("the card refuses this launch")
            return real(b, cand, graph, device)
        return make

    monkeypatch.setattr(measure, "_make_runner", bomb_on(cands[1].label()))
    entry = _search([bucket])["entries"]["128x512x4xfused"]
    assert entry["rejected"] == 1 and entry["config"] == kernels.DEFAULT_CONFIG.to_json()
    monkeypatch.setattr(measure, "_make_runner", bomb_on(cands[0].label()))
    monkeypatch.setattr(measure, "_pin", lambda device, dry: (False, None))
    entry = measure.search([bucket], device=CPU)["entries"]["128x512x4xfused"]
    assert entry["source"] == "no-survivors"
    assert entry["config"] == kernels.DEFAULT_CONFIG.to_json()


# ----------------------------------------------------------------------
# tune/record.py
# ----------------------------------------------------------------------
def test_record_save_is_byte_deterministic_and_round_trips(tmp_path):
    rec = _search()
    p1, p2 = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    save_record(rec, p1)
    save_record(_search(), p2)
    assert (tmp_path / "a.json").read_bytes() == (tmp_path / "b.json").read_bytes()
    assert (tmp_path / "a.json.sha256").exists()
    assert load_record(p1, device=CPU) == rec
    assert BUS.counters()["tune.record.hit"] == 1
    assert record.fingerprint(CPU) in record.default_record_path(str(tmp_path), device=CPU)


def test_missing_record_is_a_miss_not_an_error(tmp_path):
    assert load_record(str(tmp_path / "nope.json"), device=CPU) is None
    assert BUS.counters()["tune.record.miss"] == 1


@pytest.mark.parametrize("field,value", [
    ("fingerprint", "cuda-NVIDIA-H100-80GB-HBM3-nv-0-cuda-12.8-torch-2.11.0"),
    ("backend", "cuda"),
    ("torch_version", "0.0.1"),
])
def test_stale_records_degrade_to_none(tmp_path, field, value):
    rec = _search()
    rec[field] = value
    path = str(tmp_path / "stale.json")
    save_record(rec, path)
    assert load_record(path, device=CPU) is None
    assert BUS.counters()["tune.record.stale"] == 1
    assert load_and_install(path, device=CPU) == 0
    assert kernels.tuned_summary() is None


def test_corrupt_record_quarantines(tmp_path):
    path = str(tmp_path / "rot.json")
    save_record(_search(), path)
    raw = bytearray((tmp_path / "rot.json").read_bytes())
    raw[len(raw) // 2] ^= 0x40
    (tmp_path / "rot.json").write_bytes(bytes(raw))
    assert load_record(path, device=CPU) is None
    counters = BUS.counters()
    assert counters["tune.record.quarantined"] == 1 and counters["tune.record.stale"] == 1
    assert not os.path.exists(path)


@pytest.mark.parametrize("entry", [
    {"kernel": "xla", "config": {"hook_form": "auto", "tile_slots": 8192}},
    {"kernel": "torch"},
    {"kernel": "torch", "config": {"hook_form": "warp", "tile_slots": 8192}},
    {"kernel": "torch", "config": {"hook_form": "auto", "tile_slots": 0}},
    {"kernel": "torch", "config": {"hook_form": "auto", "tile_slots": 4096}},  # no K3 here
])
def test_malformed_entries_raise_typed_errors(tmp_path, entry):
    rec = _search()
    rec["entries"]["64x256x2xfused"] = entry
    path = str(tmp_path / "bad.json")
    save_record(rec, path)
    with pytest.raises(TuningRecordError):
        load_record(path, device=CPU)


def test_a_block_form_past_its_bucket_is_malformed(tmp_path):
    rec = _search([(4096, 8192, 16, "fused")])
    rec["entries"]["4096x8192x16xfused"]["config"]["hook_form"] = "block"
    path = str(tmp_path / "big.json")
    save_record(rec, path)
    with pytest.raises(TuningRecordError, match="not valid"):
        load_record(path, device=CPU)
    (tmp_path / "worse.json").write_text(json.dumps({"schema": "something-else"}))
    with pytest.raises(TuningRecordError):
        load_record(str(tmp_path / "worse.json"), device=CPU)
    with pytest.raises(TuningRecordError):
        save_record({"schema": "something-else"}, str(tmp_path / "x.json"))


def test_bucket_key_round_trip_and_rejection():
    b = (256, 1024, 4, "fused")
    assert record.parse_bucket_key(record.bucket_key_str(b)) == b
    assert record.bucket_key_str(b) == jrecord.bucket_key_str(b)
    for bad in ("256x1024", "axbxcxd", "1x2x3xwarp", "0x2x3xfused"):
        with pytest.raises(TuningRecordError):
            record.parse_bucket_key(bad)


def test_a_jax_record_is_stale_here_and_a_port_record_is_refused_by_jax(tmp_path):
    """Each package fingerprints its own stack: the JAX package's record
    (``xla`` winners, a ``KernelGeometry``) is stale in the port, counted,
    and installs nothing; the port's (``torch`` winners, a
    ``LaunchConfig``) fails the JAX loader's winner check, which raises
    its ``TuningRecordError`` before its staleness checks: it installs
    nothing there either."""
    jpath, tpath = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    jrecord.save_record(jmeasure.search(BUCKETS, dry=True), jpath)
    save_record(_search(), tpath)
    assert load_and_install(jpath, device=CPU) == 0
    assert BUS.counters()["tune.record.stale"] == 1 and kernels.tuned_summary() is None
    with pytest.raises(jrecord.TuningRecordError):
        jrecord.load_and_install(tpath)
    assert jpk.tuned_summary() is None


# ----------------------------------------------------------------------
# install_record and the solvers that read it
# ----------------------------------------------------------------------
def _record_with(bucket, config):
    entries = {bucket: {"kernel": "torch", "source": "measured", "config": config.to_json(),
                        "candidates": 3, "rejected": 0, "parity": "ok"}}
    return record.new_record(entries, pinned=False, device=CPU)


def test_install_record_writes_the_table_the_lane_solver_reads(monkeypatch):
    g = tgen.gnm_random_graph(100, 300, seed=3)
    bucket = (*tlanes.bucket_key(g), 2, "fused")
    plain = [r[0].tolist() for r in tlanes.solve_lanes([g, g], lanes=2, device=CPU)]
    assert install_record(_record_with(bucket, kernels.LaunchConfig("block"))) == 1
    assert kernels.tuned_config(bucket) == kernels.LaunchConfig("block")
    assert kernels.tuned_config((1, 2, 3, "fused")) == kernels.DEFAULT_CONFIG
    assert kernels.tuned_summary() == {"fingerprint": record.fingerprint(CPU), "path": None,
                                       "pinned": False, "entries": 1}
    forms = []
    real = tb.hook_and_compress

    def spy(*args, form="auto"):
        forms.append(form)
        return real(*args, form=form)

    monkeypatch.setattr(tb, "hook_and_compress", spy)
    tuned = [r[0].tolist() for r in tlanes.solve_lanes([g, g], lanes=2, device=CPU)]
    assert tuned == plain and forms and set(forms) == {"block"}
    forms.clear()
    tlanes.solve_lanes([g, g, g], lanes=3, device=CPU)  # another bucket: the default
    assert set(forms) == {"auto"}


def test_the_ell_and_single_graph_solves_read_their_buckets(monkeypatch):
    g = tgen.rmat_graph(9, 8, seed=2)
    n_pad, m_pad = tlanes.bucket_key(g)
    want = tb.solve_graph(g, strategy="ell", device=CPU)
    kernels.set_tuned_configs({(n_pad, m_pad, 0, "ell"): kernels.LaunchConfig("grid", 4096),
                               (n_pad, m_pad, 0, "fused"): kernels.LaunchConfig("block")})
    tiles, forms = [], []
    real_plan, real_hook = kernels.ell_plan, tb.hook_and_compress

    def plan_spy(buckets, *, tile_slots=kernels.ELL_TILE_SLOTS):
        tiles.append(tile_slots)
        return real_plan(buckets, tile_slots=tile_slots)

    def hook_spy(*args, form="auto"):
        forms.append(form)
        return real_hook(*args, form=form)

    monkeypatch.setattr(kernels, "ell_plan", plan_spy)
    monkeypatch.setattr(tb, "hook_and_compress", hook_spy)
    got = tb.solve_graph(g, strategy="ell", device=CPU)
    assert tiles == [4096] and set(forms) == {"grid"}
    np.testing.assert_array_equal(got[0], want[0])
    forms.clear()
    tb.solve_graph(g, strategy="fused", device=CPU)
    assert set(forms) == {"block"}


def test_warmup_installs_a_record_as_jax_does(tmp_path):
    """``run_warmup(WarmupPlan(tuning=...))`` installs first and reports
    ``tuned_entries`` as the JAX package does; a miss and a stale record
    install nothing and warmup goes on."""
    jpath, tpath = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    jrecord.save_record(jmeasure.search(BUCKETS, dry=True), jpath)
    save_record(_search(), tpath)
    plan = dict(buckets=((64, 256),), lanes=2)
    want = jwarmup.run_warmup(jwarmup.WarmupPlan(tuning=jpath, **plan))
    got = twarmup.run_warmup(twarmup.WarmupPlan(tuning=tpath, **plan), device=CPU)
    for report in (want, got):
        report.pop("wall_s"), report.pop("kernel")
    assert got == want and got["tuned_entries"] == len(BUCKETS)
    assert kernels.tuned_summary()["path"] == tpath
    kernels.set_tuned_configs(None)
    tlanes.clear_solver_cache()
    for path, counter in ((jpath, "tune.record.stale"), (str(tmp_path / "none.json"),
                                                          "tune.record.miss")):
        report = twarmup.run_warmup(twarmup.WarmupPlan(tuning=path, **plan), device=CPU)
        assert report["tuned_entries"] == 0 and report["buckets"] == 1
        assert BUS.counters()[counter] == 1 and kernels.tuned_summary() is None


# ----------------------------------------------------------------------
# utils/compile_cache.py over the native library's g++ build
# ----------------------------------------------------------------------
@pytest.fixture
def cache(tmp_path, monkeypatch):
    """A fresh cache directory, the native library not loaded; the
    repository's build roots are restored after."""
    monkeypatch.setattr(native, "_lib", None)
    path = compile_cache.enable_persistent_cache(str(tmp_path / "cache"))
    yield path
    compile_cache.disable_persistent_cache()


def _reload():
    native._lib = None
    BUS.clear()
    native.get_lib()
    return {k: v for k, v in BUS.counters().items() if k.startswith("compile.persistent.")}


def test_a_build_is_a_miss_and_a_load_a_hit(cache):
    assert _reload() == {"compile.persistent.miss": 1}
    assert str(native.library_path()).startswith(cache)
    assert _reload() == {"compile.persistent.hit": 1}
    stats = compile_cache.cache_stats()
    assert stats["enabled"] and stats["dir"] == cache and stats["entries"] == 1
    assert stats["bytes"] > os.path.getsize(native.library_path())


@pytest.mark.parametrize("damage", ["bit-rot", "no-manifest", "foreign-key", "foreign-package"])
def test_a_damaged_or_foreign_entry_is_rebuilt_and_counted(cache, damage):
    _reload()
    lib = native.library_path()
    manifest = lib.parent / compile_cache.MANIFEST
    if damage == "bit-rot":
        # A new file in its place: this process has the old one mapped.
        raw = bytearray(lib.read_bytes())
        raw[len(raw) // 2] ^= 0x40
        rotten = lib.with_suffix(".rot")
        rotten.write_bytes(bytes(raw))
        os.replace(rotten, lib)
    elif damage == "no-manifest":
        manifest.unlink()
    else:
        doc = json.loads(manifest.read_text())
        doc["key" if damage == "foreign-key" else "package"] = "someone-else"
        manifest.write_text(json.dumps(doc))
    why = "corrupt" if damage in ("bit-rot", "no-manifest") else "foreign"
    assert _reload() == {f"compile.persistent.{why}": 1, "compile.persistent.miss": 1}
    assert _reload() == {"compile.persistent.hit": 1}


def test_a_failed_build_still_raises(cache, monkeypatch):
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-fno-such-flag",))
    native._lib = None
    with pytest.raises(KernelBuildError, match="g\\+\\+ failed"):
        native.get_lib()
    assert BUS.counters()["compile.persistent.miss"] == 1
    assert not native.library_path().exists()


def test_the_build_time_is_recorded_and_the_roots_move_back(cache):
    _reload()
    compile_cache.BUS.clear()
    native._lib = None
    native.library_path().unlink()
    native.get_lib()
    assert BUS.snapshot()["histograms"]["compile.backend_s"]["count"] == 1
    compile_cache.disable_persistent_cache()
    assert native.BUILD_ROOT == compile_cache.DEFAULT_ROOT / "native"
    assert _build.BUILD_ROOT == compile_cache.DEFAULT_ROOT / "kernels"
    assert not compile_cache.cache_stats()["enabled"]


def test_default_cache_dir_honours_the_jax_packages_names(monkeypatch):
    monkeypatch.delenv("GHS_COMPILE_CACHE_DIR", raising=False)
    monkeypatch.setenv("GHS_TPU_COMPILE_CACHE", "/tmp/a")
    assert compile_cache.default_cache_dir() == "/tmp/a"
    monkeypatch.setenv("GHS_COMPILE_CACHE_DIR", "/tmp/b")
    assert compile_cache.default_cache_dir() == "/tmp/b"
    monkeypatch.delenv("GHS_COMPILE_CACHE_DIR")
    monkeypatch.delenv("GHS_TPU_COMPILE_CACHE")
    assert compile_cache.default_cache_dir().endswith(os.path.join(".cache", "ghs-torch"))
