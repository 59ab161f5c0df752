"""The port's GHS message protocol (``protocol/``, ``backend="protocol"``)
against the JAX package's, on the CPU.

The protocol is host Python over a deterministic event queue, so the bar is
equality of everything it produces: the sorted edge ids, the root-id
fragment labels, the level count, the transport's message counts, the
``protocol.*`` counters on each package's bus and, over a lossy channel,
the fault schedule and the reliable layer's ``stats``. Each forest also
equals the port's device solve (``device="cpu"``, the kernels' plain
versions) and the SciPy rank oracle.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from distributed_ghs_implementation_tpu import api as japi
from distributed_ghs_implementation_tpu import protocol as jproto
from distributed_ghs_implementation_tpu.graphs import edgelist as jedge
from distributed_ghs_implementation_tpu.graphs import generators as jgen
from distributed_ghs_implementation_tpu.obs.events import BUS as JBUS
from distributed_ghs_implementation_tpu_torch import api as tapi
from distributed_ghs_implementation_tpu_torch import protocol as tproto
from distributed_ghs_implementation_tpu_torch.graphs import edgelist as tedge
from distributed_ghs_implementation_tpu_torch.graphs import generators as tgen
from distributed_ghs_implementation_tpu_torch.models import boruvka as tb
from distributed_ghs_implementation_tpu_torch.obs.events import BUS as TBUS
from distributed_ghs_implementation_tpu_torch.utils.verify import rank_oracle_edge_ids
from torch_inputs import DECK, build_deck
from torch_pairs import CPU, isolated  # noqa: F401 -- fixture

pytestmark = pytest.mark.usefixtures("isolated")

REPO = Path(__file__).resolve().parent.parent

SIDES = {"jax": (jproto, jgen, jedge, JBUS), "port": (tproto, tgen, tedge, TBUS)}

#: The chaos drill's three fast channel specs (``utils/chaos.py``).
FAST_SPECS = [
    dict(drop=0.2, duplicate=0.1, reorder=0.3, seed=7),
    dict(drop=0.2, seed=11),
    dict(duplicate=0.1, reorder=0.3, seed=13),
]


@pytest.fixture(scope="module")
def deck():
    return build_deck(jedge, jgen, tedge, tgen)


def _protocol_counters(bus):
    return {k: v for k, v in bus.counters().items() if k.startswith("protocol.")}


def _run(side, graph, transport=None):
    """``solve_graph_protocol`` in package ``side`` on a cleared bus:
    ``(ids, fragment, levels, protocol counters)`` as plain lists."""
    proto, _, _, bus = SIDES[side]
    bus.clear()
    ids, frag, levels = proto.solve_graph_protocol(graph, transport=transport)
    return ids.tolist(), frag.tolist(), int(levels), _protocol_counters(bus)


def _both(jg, tg, make_transport=None):
    """Both packages' runs on the same graph (and a fresh transport each
    from ``make_transport(protocol module)``); asserts they are equal and
    returns the port's run and its transport."""
    out, transports = {}, {}
    for side, graph in (("jax", jg), ("port", tg)):
        proto = SIDES[side][0]
        transports[side] = make_transport(proto) if make_transport else proto.SimTransport()
        out[side] = _run(side, graph, transports[side])
    assert out["port"] == out["jax"]
    if hasattr(transports["jax"], "stats"):
        assert transports["port"].stats == transports["jax"].stats
    for name in ("messages_sent", "messages_deferred", "now"):
        assert getattr(transports["port"], name) == getattr(transports["jax"], name)
    return out["port"], transports["port"]


def _check_forest(tg, got):
    ids, frag, levels, _ = got
    want = tb.solve_graph(tg, device=CPU)
    assert ids == want[0].tolist() == rank_oracle_edge_ids(tg).tolist()
    assert np.unique(frag).size == np.unique(want[1]).size


@pytest.mark.parametrize("name", list(DECK))
def test_deck_equals_jax_and_the_device_solve(deck, name):
    jg, tg = deck[name]
    got, transport = _both(jg, tg)
    _check_forest(tg, got)
    counters = got[3]
    assert counters["protocol.messages_sent"] == transport.messages_sent > 0
    if name == "forest23":
        assert np.unique(got[1]).size == 23


@pytest.mark.parametrize("seed", range(8))
def test_erdos_renyi_equals_jax_and_the_device_solve(seed):
    got, _ = _both(jgen.erdos_renyi_graph(45, 0.15, seed=seed),
                   tgen.erdos_renyi_graph(45, 0.15, seed=seed))
    _check_forest(tgen.erdos_renyi_graph(45, 0.15, seed=seed), got)


@pytest.mark.parametrize("nodes", [20, 50])
def test_reference_configs_equal_jax(nodes):
    """The reference's 20-node config (``ghs_implementation.py:793``) and its
    50-node extrapolation: the same graph from both generators, the same
    forest, a spanning tree."""
    jg = jgen.reference_random_graph(nodes, 0.3, 500)
    tg = tgen.reference_random_graph(nodes, 0.3, 500)
    for a in "uvw":
        np.testing.assert_array_equal(getattr(tg, a), getattr(jg, a))
    got, _ = _both(jg, tg)
    _check_forest(tg, got)
    assert len(got[0]) == nodes - 1


SPECIAL = {
    "line64": lambda gen, edge: gen.line_graph(64),
    "all-equal-weights": lambda gen, edge: gen.erdos_renyi_graph(
        30, 0.2, seed=4, weight_low=5, weight_high=5),
    "disconnected-isolated": lambda gen, edge: edge.Graph.from_edges(5, [(0, 1, 1), (1, 2, 2)]),
    "no-edges": lambda gen, edge: edge.Graph.from_edges(4, []),
    "simple": lambda gen, edge: gen.simple_test_graph(),
}


@pytest.mark.parametrize("name", list(SPECIAL))
def test_special_graphs_equal_jax(name):
    make = SPECIAL[name]
    tg = make(tgen, tedge)
    got = _both(make(jgen, jedge), tg)[0]
    _check_forest(tg, got)
    if name == "disconnected-isolated":
        assert len(got[0]) == 2 and np.unique(got[1]).size == 3


@pytest.mark.parametrize("a,b", [(1, 7), (5, 1), (3, 11)])
def test_adversarial_latencies_equal_jax(a, b):
    """Skewed deterministic link delays reorder deliveries: the same
    deliveries, deferrals and forest in both packages."""
    def make(proto):
        return proto.SimTransport(latency=lambda s, d: a + ((s * 31 + d * 17) % b))

    got, _ = _both(jgen.erdos_renyi_graph(35, 0.2, seed=9),
                   tgen.erdos_renyi_graph(35, 0.2, seed=9), make)
    _check_forest(tgen.erdos_renyi_graph(35, 0.2, seed=9), got)


@pytest.mark.parametrize("spec", FAST_SPECS, ids=["all", "drop", "dup-reorder"])
@pytest.mark.parametrize("graph", ["er40-a", "line24"])
def test_reliable_transport_equals_jax(spec, graph):
    """Over the chaos drill's fast specs the reliable layer gives JAX's
    drops, duplicates, reorders, retransmits and ack latencies, and the
    exact forest."""
    def make_graph(gen):
        return (gen.erdos_renyi_graph(40, 0.12, seed=101) if graph == "er40-a"
                else gen.line_graph(24))

    got, transport = _both(make_graph(jgen), make_graph(tgen),
                           lambda proto: proto.ReliableTransport(proto.FaultSpec(**spec)))
    _check_forest(make_graph(tgen), got)
    if spec.get("drop"):
        assert transport.stats["dropped"] > 0 and transport.stats["retransmits"] > 0
    assert got[3]["protocol.retransmits"] == transport.retransmits


@pytest.mark.parametrize("spec", FAST_SPECS, ids=["all", "drop", "dup-reorder"])
def test_faulty_transport_equals_jax(spec):
    """The raw lossy channel under the protocol: the same schedule in both
    packages. GHS assumes reliable FIFO links, so a lost or repeated
    message can truncate the forest, trip the event guard or break a
    node's state machine; whatever happens, both packages do the same."""
    outs = {}
    for side, (proto, gen, _, bus) in SIDES.items():
        t = proto.FaultyTransport(proto.FaultSpec(**spec), max_events=20_000)
        try:
            result = _run(side, gen.erdos_renyi_graph(40, 0.12, seed=102), t)
        except (RuntimeError, KeyError) as ex:
            result = (type(ex).__name__, str(ex))
        outs[side] = (result, t.dropped, t.duplicated, t.jittered, t.messages_sent,
                      t.messages_deferred)
    assert outs["port"] == outs["jax"]
    if spec.get("drop"):
        assert outs["port"][1] > 0


def test_faulty_blast_and_reliable_blast_equal_jax():
    """200 sends across one link: the faulty channel's deliveries and the
    reliable layer's exactly-once, in-order delivery, as in JAX."""
    class Recorder:
        def __init__(self):
            self.seen = []

        def handle(self, msg):
            self.seen.append(msg.fragment)
            return True

    outs = {}
    for side, (proto, _, _, _) in SIDES.items():
        got = []
        for t in (proto.FaultyTransport(proto.FaultSpec(drop=0.3, duplicate=0.2, reorder=0.4,
                                                        seed=5)),
                  proto.ReliableTransport(proto.FaultSpec(drop=0.2, duplicate=0.2, reorder=0.5,
                                                          seed=9))):
            nodes = {0: Recorder(), 1: Recorder()}
            for i in range(200):
                t.send(0, 1, proto.Message(proto.MessageType.TEST, sender=0, fragment=i))
            t.run(nodes)
            got.append((nodes[1].seen, t.messages_sent, t.dropped, t.duplicated))
        got.append(t.stats)
        outs[side] = got
    assert outs["port"] == outs["jax"]
    assert outs["port"][1][0] == list(range(200))


def test_fault_spec_and_retry_limits_raise_as_jax():
    with pytest.raises(ValueError, match="probability"):
        tproto.FaultSpec(drop=1.5)
    with pytest.raises(ValueError, match="max_jitter"):
        tproto.FaultSpec(max_jitter=0)
    with pytest.raises(ValueError, match="severs"):
        tproto.ReliableTransport(tproto.FaultSpec(drop=1.0))
    t = tproto.ReliableTransport(tproto.FaultSpec(drop=0.95, seed=3), max_retries=3)
    nodes = {0: None, 1: type("N", (), {"handle": lambda self, m: True})()}
    for i in range(50):
        t.send(0, 1, tproto.Message(tproto.MessageType.TEST, sender=0, fragment=i))
    with pytest.raises(RuntimeError, match="gave up"):
        t.run(nodes)


def test_livelock_guard_raises():
    """A node that defers every message trips ``max_events`` instead of
    spinning, in both packages, at the same event."""
    class AlwaysDefer:
        def handle(self, msg):
            return False

    errors = {}
    for side, (proto, _, _, _) in SIDES.items():
        t = proto.SimTransport(max_events=1000)
        t.send(0, 1, proto.Message(proto.MessageType.CONNECT, sender=0))
        with pytest.raises(RuntimeError, match="did not quiesce") as ex:
            t.run({1: AlwaysDefer()})
        errors[side] = (str(ex.value), t.messages_deferred)
    assert errors["port"] == errors["jax"]


def test_api_backend_protocol_equals_jax_and_keeps_the_device_rule():
    for make in (lambda g: g.readme_sample_graph(),
                 lambda g: g.erdos_renyi_graph(60, 0.15, seed=3)):
        got = tapi.minimum_spanning_forest(make(tgen), backend="protocol", device=CPU)
        want = japi.minimum_spanning_forest(make(jgen), backend="protocol")
        assert got.backend == want.backend == "protocol"
        np.testing.assert_array_equal(got.edge_ids, want.edge_ids)
        assert (got.num_levels, got.num_components, got.total_weight) == (
            want.num_levels, want.num_components, want.total_weight)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tapi.minimum_spanning_forest(tgen.readme_sample_graph(), backend="protocol")


def test_run_protocol_node_states_equal_jax():
    """Every node's final state, level, fragment name and edge states."""
    def states(nodes):
        return {v: (n.state.name, n.level, n.fragment, n.halted, n.messages_processed,
                    sorted((e.neighbor, e.rank, e.state.name) for e in n.edges.values()))
                for v, n in nodes.items()}

    jn, jt = jproto.run_protocol(jgen.erdos_renyi_graph(30, 0.2, seed=5))
    tn, tt = tproto.run_protocol(tgen.erdos_renyi_graph(30, 0.2, seed=5))
    assert states(tn) == states(jn)
    assert (tt.messages_sent, tt.messages_deferred) == (jt.messages_sent, jt.messages_deferred)


def test_new_modules_import_without_jax():
    """``protocol/``, the chaos drill, the diagnostics, the build cache and
    ``tune/`` import and run with JAX blocked and load no module of the
    JAX package."""
    code = (
        "import sys, tempfile\n"
        "sys.modules['jax'] = None\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "from distributed_ghs_implementation_tpu_torch import (\n"
        "    minimum_spanning_forest, protocol, tune)\n"
        "from distributed_ghs_implementation_tpu_torch.graphs.generators import (\n"
        "    readme_sample_graph)\n"
        "from distributed_ghs_implementation_tpu_torch.tune import measure, record, space\n"
        "from distributed_ghs_implementation_tpu_torch.utils import (\n"
        "    chaos, compile_cache, diagnostics)\n"
        "g = readme_sample_graph()\n"
        "r = minimum_spanning_forest(g, backend='protocol', device='cpu')\n"
        "assert r.total_weight == 20 and r.backend == 'protocol', r\n"
        "nodes, _ = protocol.run_protocol(g)\n"
        "assert diagnostics.failure_report(r, nodes=nodes)['protocol']['nodes']\n"
        "rep = chaos.run_chaos_drill(fast=True, include_solver=False, device='cpu')\n"
        "assert rep['ok'] and rep['num_cases'] == 12, rep['num_failed']\n"
        "rec = tune.search([(8, 16, 2, 'fused')], dry=True, device='cpu')\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    tune.save_record(rec, d + '/t.json')\n"
        "    assert tune.load_and_install(d + '/t.json', device='cpu') == 1\n"
        "    assert compile_cache.enable_persistent_cache(d).startswith(d)\n"
        "    compile_cache.disable_persistent_cache()\n"
        "bad = [m for m in sys.modules if m == 'distributed_ghs_implementation_tpu' "
        "or m.startswith('distributed_ghs_implementation_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
