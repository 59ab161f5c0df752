"""The readers of the system's own spans and counters (``program.py`` and
the ``program_span`` / ``program_counter`` metrics), against a synthetic
run record over a bus whose events are set by hand, and in a short traced
run of a small copy of the cell."""

import pytest

from ghs_bench import harness, program

LO, HI = 10.0, 20.0  # the window, host clock (s)


class FakeBus:
    """Events ``(ph, name, cat, ts_ns, dur_ns, tid, args)`` whose stamps
    are host-clock nanoseconds."""

    def __init__(self, events, dropped=0):
        self._events, self.dropped = events, dropped

    def events(self):
        return list(self._events)

    @staticmethod
    def perf_counter_s(ts_ns):
        return ts_ns * 1e-9


def _x(name, start, end, **args):
    return ("X", name, "solver", int(start * 1e9), int((end - start) * 1e9), 1, args or None)


def _c(name, t, value):
    return ("C", name, "solver", int(t * 1e9), 0, 1, {"value": value})


def _record(solves=2, edges=100):
    return harness.RunRecord(cell=None, window=(LO, HI), spans=harness.Spans(),
                             memory_peak_bytes=0,
                             solves=[{"edges": edges} for _ in range(solves)])


@pytest.fixture
def bus(monkeypatch):
    def use(events, dropped=0):
        fake = FakeBus(events, dropped)
        monkeypatch.setattr(program, "_bus", lambda: fake)
        return fake
    return use


def _reader(name):
    cell = harness.find_cell(harness.load_spec(), "rmat24-fresh")
    return harness.load_reader(cell, name)


def test_a_span_metric_is_its_seconds_in_the_window_a_solve(bus):
    bus([_x("solver.prep.rank_order", 9.0, 11.0),  # opens before the window: left out
         _x("solver.prep.rank_order", 11.0, 12.5),
         _x("solver.prep.rank_order", 14.0, 14.5),
         _x("solver.prep.level1", 12.5, 13.0),
         _x("solver.prep.first_ranks", 13.0, 13.25),
         _x("solver.prep.level2", 19.5, 20.5)])  # closes after it: left out
    record = _record(solves=2)
    assert _reader("rank_order_s.solve")(record) == pytest.approx(1.0)
    assert _reader("host_levels_s.solve")(record) == pytest.approx(0.375)
    assert _reader("endpoints_s.solve")(record) is None  # no such span
    assert program.seconds_per_solve(_record(solves=0), "solver.prep.level1") is None


def test_a_system_without_the_host_clock_reads_nothing(monkeypatch):
    monkeypatch.setattr(program, "_bus", lambda: None)
    for name in ("rank_order_s.solve", "stage_issue_s.solve", "copy_wait_s.solve",
                 "staged_bytes_per_edge.solve"):
        assert _reader(name)(_record()) is None


def test_the_counter_grows_by_its_last_total_in_the_window_less_the_last_before(bus):
    name = "solver.stage.h2d_bytes"
    bus([_c(name, 5.0, 300), _c(name, 9.0, 400), _c(name, 12.0, 900), _c(name, 18.0, 1400),
         _c(name, 25.0, 9000), _c("other", 15.0, 7)])
    assert program.counter_delta(_record(), name) == 1000
    assert _reader("staged_bytes_per_edge.solve")(_record(solves=2, edges=100)) == 5.0
    bus([_c(name, 12.0, 900)])
    assert program.counter_delta(_record(), name) == 900  # started in the window
    bus([_c(name, 12.0, 900)], dropped=3)
    assert program.counter_delta(_record(), name) is None  # its start was overwritten
    bus([_c(name, 9.0, 400)])
    assert program.counter_delta(_record(), name) is None  # nothing in the window


def test_the_device_idle_goes_to_the_leaf_program_span_open_over_it(bus):
    """The program's leaf spans, put on the device trace's nanoseconds,
    take the device's idle gaps as the benchmark's own spans do."""
    bus([_x("solver.prep.rank_order", 11.0, 12.0), _x("solver.prep.stage", 12.0, 12.5),
         _x("solver.prep.copy_wait", 12.5, 13.0)])
    leaves = [(a * 1e9, b * 1e9, n) for n, a, b, _ in
              program.spans(_record(), "solver.prep.rank_order", "solver.prep.stage",
                            "solver.prep.copy_wait")]
    gaps = [(10.5e9, 12.2e9), (12.6e9, 14.0e9)]
    got = harness.idle_by_span(gaps, leaves)
    want = {"no benchmark span": 0.5 + 1.0, "solver.prep.rank_order": 1.0,
            "solver.prep.stage": 0.2, "solver.prep.copy_wait": 0.4}
    assert got == pytest.approx(want)


def test_a_traced_run_reads_every_program_metric(small_bench, run_small):
    line, _ = run_small(small_bench, "rmat24-fresh", seconds=2.0, trace=True)
    assert line["correct"]
    metrics = line["metrics"]
    names = ("rank_order_s.solve", "endpoints_s.solve", "host_levels_s.solve",
             "stage_issue_s.solve", "copy_wait_s.solve", "staged_bytes_per_edge.solve")
    assert all(metrics[name]["value"] >= 0 for name in names)
    steps = sum(metrics[name]["value"] for name in names[:5])
    assert steps <= metrics["prep_s.solve"]["value"]
    assert metrics["staged_bytes_per_edge.solve"]["value"] >= 8.0  # two int32 a rank
