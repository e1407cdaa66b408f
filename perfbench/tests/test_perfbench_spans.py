"""The readers of the port's spans (``perfbench/spans.py`` and the eleven
metrics over it) on a synthetic Chrome trace whose spans and device
intervals are known: each reads its exact value, and None where the trace
holds none of its spans (a program without them).
"""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from perfbench import harness, trace

BENCH = harness.load_json(harness.ROOT, "BENCHMARK.json")
T = 5   # steps a chunk


def x(name, ts, end, cat="user_annotation"):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": end - ts}


# Two chunks in a window of 1,000 us.  Chunk A [0, 500): prologue 50 us
# with two uploads, issue [60, 300), fold [300, 400) with read-backs of 20
# and 10 us; chunk B [500, 1000): prologue 80 us with two uploads and a
# read-back of 8 us, issue [590, 850), fold [850, 950) with read-backs of
# 40 and 5 us.  The device runs [70, 290), [320, 330) and [600, 840).
CHUNKS = [
    x("perfbench.window", 0, 1000),
    x("perfbench.call", 0, 500), x("perfbench.call", 500, 1000),
    x("mgt.chunk.prologue", 10, 60), x("mgt.upload", 40, 45),
    x("mgt.upload", 50, 52), x("mgt.chunk.issue", 60, 300),
    x("mgt.chunk.fold", 300, 400), x("mgt.readback", 310, 330),
    x("mgt.readback", 340, 350),
    x("mgt.chunk.prologue", 510, 590), x("mgt.upload", 520, 525),
    x("mgt.upload", 530, 535), x("mgt.readback", 540, 548),
    x("mgt.chunk.issue", 590, 850), x("mgt.chunk.fold", 850, 950),
    x("mgt.readback", 860, 900), x("mgt.readback", 910, 915),
    x("learn_fwd_kernel", 70, 290, "kernel"),
    x("Memcpy DtoH", 320, 330, "gpu_memcpy"),
    x("learn_fwd_kernel", 600, 840, "kernel"),
    x("cudaLaunchKernel", 65, 68, "cuda_runtime"),
]
# Three matchups with prologues of 100, 300 and 200 us.
MATCHUPS = [
    x("perfbench.window", 0, 3000),
    *(x("perfbench.call", 1000 * i, 1000 * (i + 1)) for i in range(3)),
    x("mgt.eval.prologue", 0, 100), x("mgt.eval.prologue", 1000, 1300),
    x("mgt.eval.prologue", 2000, 2200),
    x("policy_kernel", 100, 900, "kernel"),
]

# Idle [0, 70), [290, 320), [330, 600), [840, 1000); outside the issue
# spans: 60 + 20 + 260 + 150 = 490 us of 1,000.
WANT = {
    "host_prologue_ms": (50 + 80) / 2 / 1e3,
    "host_issue_us_per_step": (240 + 260) / (2 * T),
    "readback_wait_ms": (30 + 53) / 2 / 1e3,
    "idle_boundary_share": 49.0,
    "host_transfers_per_chunk": 9 / 2,
}
NEW = [f"{m}.{cell}" for cell in ("train", "train_rainbow") for m in WANT]
NEW.append("matchup_prologue_ms.eval")


def run_of(events, calls):
    t = trace.read_events(events, calls, 0.0)
    return harness.Run(SimpleNamespace(T=T), 0.0, harness.Window(), t)


def without_spans(events):
    return [e for e in events if not e["name"].startswith("mgt.")]


def test_the_eleven_are_entries_of_the_benchmark():
    names = {m["name"] for m in BENCH["per_layer"]}
    assert set(NEW) <= names and len(NEW) == 11


@pytest.mark.parametrize("name", NEW)
def test_reader_reads_its_exact_value(name):
    if name.endswith(".eval"):
        got = harness.reader(name).read(run_of(MATCHUPS, 3))
        assert got == 0.2
        return
    got = harness.reader(name).read(run_of(CHUNKS, 2))
    assert got == WANT[name.split(".")[0]]


@pytest.mark.parametrize("name", NEW)
def test_reader_without_spans_reads_none(name):
    events, calls = (MATCHUPS, 3) if name.endswith(".eval") else (CHUNKS, 2)
    assert harness.reader(name).read(run_of(without_spans(events),
                                            calls)) is None


@pytest.mark.parametrize("name", NEW)
def test_reader_of_an_untraced_run_reads_none(name):
    run = harness.Run(SimpleNamespace(T=T), 0.0, harness.Window(), None)
    assert harness.reader(name).read(run) is None


def test_boundary_idle_is_part_of_the_idle():
    run = run_of(CHUNKS, 2)
    idle = harness.reader("idle_share.train").read(run)
    assert idle == 53.0
    assert harness.reader("idle_boundary_share.train").read(run) <= idle
