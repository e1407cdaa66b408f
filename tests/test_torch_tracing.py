"""The port's own spans (``utils.profiling.span``) in the fused host paths.

With no profiler running a span is one shared null context and never
enters ``record_function``.  Under ``torch.profiler`` one K5 chunk, one K8
chunk, one K9 chunk and one ``evaluate_fused`` each leave exactly their
span names in the exported Chrome trace, nested as the phases are (the
read-backs inside the prologue or the fold, the phases one after the
other), with the card path's read-backs per chunk: K5 two (``_finish``),
K8 four (``_sync_start``'s two, ``_finish``'s two when the last step
learned), K9 two (``_finish``), ``evaluate_fused`` one.  The CPU runs
the plain versions, which share those functions with the card path; the
uploads exist only on the card.

The card's case (``-m cuda``, skipped without one) counts the uploads and
checks that the spans and the card's kernels share one clock.  That check
runs in a new process whose first profile with CUDA activity is its
trace.  On an H100 a later such profile in a process, a minute or more
after the first, lost some or all of its kernels (a probe of 5 kernels
kept 0 at 60, 120 and 210 s after the first; a new process's first
profile after 210 s idle kept all 5):

    python -m pytest --noconftest -o addopts="" -m cuda \\
        tests/test_torch_tracing.py
"""

import contextlib
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from merging_gym_tpu_torch import kernels
from merging_gym_tpu_torch.agents.dqn import DQNConfig
from merging_gym_tpu_torch.agents.drqn import DRQNConfig
from merging_gym_tpu_torch.agents.evaluate import evaluate_fused
from merging_gym_tpu_torch.agents.rainbow import RainbowConfig
from merging_gym_tpu_torch.core.env import EnvParams
from merging_gym_tpu_torch.nn.mlp import qnet_init
from merging_gym_tpu_torch.ops import fused_drqn as FD
from merging_gym_tpu_torch.ops import fused_rainbow as FRB
from merging_gym_tpu_torch.ops import fused_trainer as FT
from merging_gym_tpu_torch.utils import profiling

CPU = torch.device("cpu")
N = 128
STEPS = 3
EP = EnvParams(max_steps=12)
CHUNK = {"mgt.chunk.prologue", "mgt.chunk.issue", "mgt.chunk.fold",
         "mgt.readback"}
EVAL = {"mgt.eval.prologue", "mgt.eval.rollout", "mgt.eval.outcomes",
        "mgt.readback"}
K5_KERNELS = ("act_env_store_kernel", "learn_fwd_kernel",
              "learn_grad_kernel")
EPS_US = 0.002   # the export prints microseconds to three places
HERE = pathlib.Path(__file__).resolve().parent


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """``tests/torch_threads.py``'s fixture, kept here: on the card this
    file runs without the conftest, where ``tests`` may not import."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def dqn_run(device):
    cfg = DQNConfig(lr=1e-3, memory_capacity=2 * N)
    carry = FT.fused_dqn_init(0, cfg, EP, N, device=device)
    return lambda: FT.fused_dqn_chunk(cfg, EP, carry, STEPS, seed=3)


def rainbow_run(device):
    cfg = RainbowConfig(memory_capacity=2 * N, opponent=FT.OPP_L0)
    carry = FRB.fused_rainbow_init(0, cfg, EP, N, device=device)
    return lambda: FRB.fused_rainbow_chunk(cfg, EP, carry, STEPS, seed=3)


def drqn_run(device):
    cfg = DRQNConfig(memory_capacity=2 * N)
    carry = FD.fused_drqn_init(0, cfg, EP, N, device=device)
    return lambda: FD.fused_drqn_chunk(cfg, EP, carry, STEPS, seed=3)


def qnets(device):
    g = torch.Generator(device=device).manual_seed(5)
    return qnet_init(g, 10, 5), qnet_init(g, 10, 5)


def eval_run(device):
    p1, p2 = qnets(device)
    return lambda: evaluate_fused(p1, p2, EP, num_envs=N, num_steps=20,
                                  greedy=False, seed=7, device=device)


RUNS = {"k5": dqn_run, "k8": rainbow_run, "k9": drqn_run, "eval": eval_run}


def traced(fn, tmp_path, cuda=False):
    """Run ``fn`` under ``torch.profiler``; the exported trace's complete
    events ``(name, cat, start_us, end_us)``."""
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        fn()
        if cuda:
            torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"], e.get("cat", ""), float(e["ts"]),
             float(e["ts"]) + float(e["dur"]))
            for e in events if e.get("ph") == "X" and "dur" in e]


def spans(events, name=None):
    """The host's ``mgt.*`` spans (or those called ``name``), in order of
    start.  With CUDA activity the profiler also draws each span on the
    card's timeline (``gpu_user_annotation``); those are left out."""
    return sorted(((n, s, e) for n, cat, s, e in events
                   if cat == "user_annotation" and n.startswith("mgt.")
                   and name in (None, n)),
                  key=lambda x: x[1])


def inside(child, parent):
    return (parent[1] - EPS_US <= child[1]
            and child[2] <= parent[2] + EPS_US)


def test_span_outside_a_profile_is_the_shared_null_context(monkeypatch):
    def boom(name):
        raise AssertionError(f"record_function({name!r}) entered")
    monkeypatch.setattr(profiling.profiler, "record_function", boom)
    first, second = profiling.span("mgt.a"), profiling.span("mgt.b")
    assert first is second
    assert isinstance(first, contextlib.nullcontext)
    with first, second:   # reusable and nestable
        pass


@pytest.mark.parametrize("kind", sorted(RUNS))
def test_no_profile_no_record_function(kind, monkeypatch):
    """A whole chunk or matchup outside a profile enters no span."""
    run = RUNS[kind](CPU)

    def boom(name):
        raise AssertionError(f"record_function({name!r}) entered")
    monkeypatch.setattr(profiling.profiler, "record_function", boom)
    run()


@pytest.mark.parametrize("kind", ["k5", "k8", "k9"])
def test_chunk_spans_under_the_profiler(kind, tmp_path):
    events = traced(RUNS[kind](CPU), tmp_path)
    found = spans(events)
    assert {n for n, _, _ in found} == CHUNK
    prologue, = spans(events, "mgt.chunk.prologue")
    issue, = spans(events, "mgt.chunk.issue")
    fold, = spans(events, "mgt.chunk.fold")
    assert prologue[2] <= issue[1] + EPS_US and issue[2] <= fold[1] + EPS_US
    reads = spans(events, "mgt.readback")
    in_fold = [r for r in reads if inside(r, fold)]
    in_prologue = [r for r in reads if inside(r, prologue)]
    assert len(in_fold) == 2
    assert len(in_prologue) == (2 if kind == "k8" else 0)
    assert len(reads) == len(in_fold) + len(in_prologue)
    assert not spans(events, "mgt.upload")   # the CPU uploads nothing


def test_eval_spans_under_the_profiler(tmp_path):
    events = traced(RUNS["eval"](CPU), tmp_path)
    assert {n for n, _, _ in spans(events)} == EVAL
    prologue, = spans(events, "mgt.eval.prologue")
    rollout, = spans(events, "mgt.eval.rollout")
    outcomes, = spans(events, "mgt.eval.outcomes")
    read, = spans(events, "mgt.readback")
    assert prologue[2] <= rollout[1] + EPS_US
    assert rollout[2] <= outcomes[1] + EPS_US
    assert inside(read, outcomes)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_uploads_and_one_clock_on_the_card(cuda, tmp_path):
    """K5 uploads its two sample streams a chunk, K8 five (episode totals,
    rounds, cols, us, gamma powers), ``evaluate_fused`` one per net held
    in host memory and none for nets on the card; then
    ``assert_one_clock``."""
    for kind, uploads in (("k5", 2), ("k8", 5)):
        events = traced(RUNS[kind](cuda), tmp_path)
        assert len(spans(events, "mgt.upload")) == uploads, kind
        assert len(spans(events, "mgt.readback")) == (2 if kind == "k5"
                                                      else 4), kind
    p1, p2 = qnets(cuda)
    host = [{k: {n: np.asarray(v.cpu()) for n, v in layer.items()}
             for k, layer in p.items()} for p in (p1, p2)]
    for nets, uploads in ((host, 2), ((p1, p2), 0)):
        events = traced(lambda: evaluate_fused(
            *nets, EP, num_envs=N, num_steps=20, greedy=False, seed=7,
            device=cuda), tmp_path, cuda=True)
        assert len(spans(events, "mgt.upload")) == uploads
    one_clock_in_a_new_process(tmp_path)


def one_clock_in_a_new_process(tmp_path, first=""):
    """``assert_one_clock`` in a new process, after the statements
    ``first`` (with ``T`` this module, ``cuda`` and ``tmp``), so that its
    trace is the process's first profile with CUDA activity."""
    code = "\n".join((
        "import pathlib, sys, torch",
        f"sys.path[:0] = [{str(HERE)!r}, {str(HERE.parent)!r}]",
        "import test_torch_tracing as T",
        f"cuda, tmp = torch.device('cuda'), pathlib.Path({str(tmp_path)!r})",
        first, "T.assert_one_clock(cuda, tmp)"))
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=900)
    assert run.returncode == 0, run.stderr[-4000:]


def assert_one_clock(cuda, tmp_path):
    """Every K5 kernel of two traced chunks starts after its chunk's
    prologue starts and ends before the chunk's last read-back ends, as
    many kernels as the chunk launched."""
    chunk = dqn_run(cuda)
    chunk()   # builds the library and warms the shapes
    before = sum(kernels.launch_counts[k] for k in (
        "dqn_act_env_store", "dqn_learn_fwd", "dqn_learn_grad"))

    def two():
        chunk()
        chunk()
    events = traced(two, tmp_path, cuda=True)
    launched = sum(kernels.launch_counts[k] for k in (
        "dqn_act_env_store", "dqn_learn_fwd", "dqn_learn_grad")) - before
    starts = [s for _, s, _ in spans(events, "mgt.chunk.prologue")]
    reads = spans(events, "mgt.readback")
    assert len(starts) == 2 and len(reads) == 4
    bounds = starts + [float("inf")]
    ends = [max(e for _, s, e in reads if bounds[i] <= s < bounds[i + 1])
            for i in range(2)]    # each chunk's last read-back
    found = [0, 0]
    for name, cat, s, e in events:
        if cat != "kernel" or not any(k in name for k in K5_KERNELS):
            continue
        owners = [i for i in range(2) if starts[i] <= s]
        assert owners, (name, s, "starts before the first prologue")
        i = owners[-1]
        assert e <= ends[i], (name, s, e, ends[i])
        found[i] += 1
    assert found[0] == found[1] and sum(found) == launched


@pytest.mark.cuda
def test_k9_chunk_spans_on_the_card(cuda, tmp_path):
    """A K9 chunk on the card leaves the five span names: one upload (the
    learner workspace's bias columns; rounds and cols are launch
    arguments) in the prologue, two read-backs in the fold."""
    events = traced(RUNS["k9"](cuda), tmp_path)
    assert {n for n, _, _ in spans(events)} == CHUNK | {"mgt.upload"}
    prologue, = spans(events, "mgt.chunk.prologue")
    fold, = spans(events, "mgt.chunk.fold")
    upload, = spans(events, "mgt.upload")
    assert inside(upload, prologue)
    reads = spans(events, "mgt.readback")
    assert len(reads) == 2 and all(inside(r, fold) for r in reads)


@pytest.mark.cuda
def test_one_clock_after_a_k9_chunk(cuda, tmp_path):
    """The K5 clock case holds after a K9 chunk in the same process (run
    under a host-only profile, as the K9 case runs it): K9 leaves nothing
    behind that drops a later chunk's kernels from the trace."""
    one_clock_in_a_new_process(tmp_path, first="\n".join((
        "T.traced(T.RUNS['k9'](cuda), tmp)",
        "torch.cuda.synchronize()")))
