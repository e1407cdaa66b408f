"""K5's fully warm chunk as one CUDA graph (``ops.fused_trainer.ChunkGraph``),
without a card: the host's half.

The chunk header (``chunk_header``) of consecutive chunks, decoded as the
kernels decode it (``dqn_trainer.cu``: ``act_env_store_kernel``'s step,
round and key, ``header_syncs`` and the bias table of
``learn_grad_kernel``), gives every step the values that ``_schedule`` and
the eager launch loop give it; the vectorised bias table is bit for bit
``adam_bias_corrections``; only fully warm chunks on the card take the
graph; and the header's layout and the three C entries' parameters are
those of ``dqn_trainer.cu``.  The card's half is in
``tests/test_torch_cuda.py``.
"""

import ctypes
import os
import re

import numpy as np
import pytest
import torch

from merging_gym_tpu_torch import kernels
from merging_gym_tpu_torch.agents.dqn import DQNConfig
from merging_gym_tpu_torch.core.env import EnvParams
from merging_gym_tpu_torch.ops import fused_trainer as FT
from merging_gym_tpu_torch.ops import philox
from tests.torch_threads import one_torch_thread  # noqa: F401


def _source():
    with open(os.path.join(kernels.CSRC, "dqn_trainer.cu")) as f:
        return f.read()


def _decode(header, R, K, num_steps, target_sync):
    """Per step ``(i, ring round, sync, Adam t, philox step, (k0, k1), c1,
    c2, rounds, cols)`` as the kernels read them from the header."""
    b, r, c, end = FT.header_layout(num_steps, K)
    h = header[:b].view(FT.HEADER)[0]
    bias = header[b:r].view(np.float32)
    rounds, cols = header[r:c].view(np.int32), header[c:end].view(np.int32)
    for i in range(num_steps):
        yield (i, (int(h["base"]) + i) % R,
               (int(h["prior"]) + i) % target_sync == 0, int(h["prior"]) + i + 1,
               (int(h["step0"]) + i) & philox.MASK32,
               (int(h["k0"]), int(h["k1"])), bias[2 * i], bias[2 * i + 1],
               list(rounds[i * K:(i + 1) * K]), list(cols[i * K:(i + 1) * K]))


@pytest.mark.parametrize("R,K,T,target_sync", [(4, 1, 200, 100),
                                               (3, 2, 7, 3), (16, 4, 1, 5)])
def test_header_reproduces_the_schedule_of_consecutive_chunks(R, K, T,
                                                              target_sync):
    """Five chunks from a step count 2 ** 32 - 2 T: the Philox step wraps
    in the third, the learn count crosses target syncs; every step's round,
    sync, Adam step, bias corrections, Philox step, key and draws are the
    eager path's."""
    ep = EnvParams()
    steps = (1 << 32) - 2 * T
    carry = {"R": R, "K": K, "warm": 1, "steps": steps,
             "learns": 5 * target_sync - 2}
    rng = np.random.default_rng(R * T)
    syncs = 0
    for chunk in range(5):
        assert FT.fully_warm(carry, T)
        assert FT.chunk_learns(carry, T) == T
        seed = int(rng.integers(0, 1 << 63)) + chunk
        rounds = rng.integers(0, R, T * K).astype(np.int32)
        cols = rng.integers(0, 8, T * K).astype(np.int32)
        header = FT.chunk_header(carry, T, seed, rounds, cols)
        assert header.nbytes == FT.header_layout(T, K)[3]
        eager = FT._schedule(FT.launch_cfg(carry, ep, seed), R, T, target_sync)
        for got, (i, r_cur, learn, sync, t) in zip(
                _decode(header, R, K, T, target_sync), eager, strict=True):
            gi, g_round, g_sync, g_t, g_step, key, c1, c2, g_r, g_c = got
            assert learn and (gi, g_round, g_sync, g_t) == (i, r_cur, sync, t)
            assert g_step == (carry["steps"] + i) & philox.MASK32
            assert key == philox.seed_key(seed)
            want = np.array(FT.adam_bias_corrections(t), np.float32)
            assert np.array_equal(np.array([c1, c2]).view(np.int32),
                                  want.view(np.int32))
            assert g_r == list(rounds[i * K:(i + 1) * K])
            assert g_c == list(cols[i * K:(i + 1) * K])
            syncs += g_sync
        carry = {**carry, "steps": carry["steps"] + T,
                 "learns": carry["learns"] + FT.chunk_learns(carry, T)}
    assert carry["steps"] > philox.MASK32  # the step wrapped
    assert syncs >= (1 if 5 * T >= target_sync else 0)


def _scalar_table(ts):
    return torch.tensor([FT.adam_bias_corrections(int(t)) for t in ts],
                        dtype=torch.float32)


@pytest.mark.parametrize("prior,num_steps", [
    (0, 5000), ((1 << 24) - 300, 600), (123_456_789, 200),
    (4_000_000_000, 200), ((1 << 40) + 17, 50)])
def test_bias_table_is_the_scalar_function_bit_for_bit(prior, num_steps):
    """From t = 1, around 2 ** 24 (where f32 stops holding every t) and
    at larger t, on the f32 bits."""
    table = FT.bias_table(prior, num_steps)
    want = _scalar_table(range(prior + 1, prior + num_steps + 1))
    assert table.dtype == torch.float32 and table.shape == (num_steps, 2)
    assert torch.equal(table.view(torch.int32), want.view(torch.int32))


def test_bias_table_at_sampled_steps():
    rng = np.random.default_rng(23)
    for prior in rng.integers(0, 1 << 45, 40):
        table = FT.bias_table(int(prior), 3)
        want = _scalar_table(range(int(prior) + 1, int(prior) + 4))
        assert torch.equal(table.view(torch.int32), want.view(torch.int32))


def test_only_fully_warm_chunks_take_the_graph():
    """Over a run from a fresh carry, ``fully_warm`` is ``chunk_learns ==
    num_steps`` (the warm-up chunks are not, every later one is); a 0-step
    chunk is refused as before; on the CPU no chunk makes or replays a
    graph."""
    n = 128
    cfg = DQNConfig(lr=1e-3, target_sync=3, memory_capacity=4 * n)
    ep = EnvParams(max_steps=40)
    carry = FT.fused_dqn_init(0, cfg, ep, n, device="cpu")
    assert not FT.fully_warm(carry, 0)
    with pytest.raises(ValueError, match="num_steps must be >= 1"):
        FT.fused_dqn_chunk(cfg, ep, carry, 0, 0)
    before, cache = dict(kernels.graph_counts), dict(FT._GRAPH)
    seen = []
    for seed, T in enumerate((1, 1, 2, 1, 3)):
        warm = FT.fully_warm(carry, T)
        assert warm == (FT.chunk_learns(carry, T) == T)
        seen.append(warm)
        carry = FT.fused_dqn_chunk(cfg, ep, carry, T, seed, greedy=True)
    assert seen == [False, False, False, True, True]
    assert kernels.graph_counts == before and FT._GRAPH == cache


def test_a_shape_is_captured_when_two_warm_chunks_come_in_a_row(
        monkeypatch):
    """``chunk_graph``: a shape's first fully warm chunk is issued launch
    by launch, the next one in a row makes the shape's graph, and later
    ones take that graph until another shape's is made; shapes that
    alternate make none."""
    made = []

    class Made:
        def __init__(self, key, *args):
            self.key = key
            made.append(self)

    monkeypatch.setattr(FT, "ChunkGraph", Made)
    monkeypatch.setattr(FT, "chunk_geometries", lambda *args: (None, None))
    monkeypatch.setattr(FT, "_GRAPH", {"graph": None, "seen": None})
    n = 128
    cfg = DQNConfig(lr=1e-3, target_sync=3, memory_capacity=4 * n)
    ep = EnvParams()
    carry = FT.fused_dqn_init(0, cfg, ep, n, device="cpu")

    def graphs(lengths):
        return [FT.chunk_graph(cfg, ep, carry, T, False, torch.float32)
                for T in lengths]

    got = graphs((1, 1, 1, 200, 200, 200, 1, 1))
    assert len(made) == 3
    assert got == [None, made[0], made[0], None, made[1], made[1], None,
                   made[2]]
    assert [g.key[6] for g in made] == [1, 200, 1]
    assert FT._GRAPH["graph"] is made[2]
    monkeypatch.setattr(FT, "_GRAPH", {"graph": None, "seen": None})
    assert graphs((1, 200, 1, 200, 1)) == [None] * 5 and len(made) == 3


def test_header_layout_is_the_c_struct():
    """``HEADER`` has the fields of ``struct ChunkHeader`` in order, at
    the offsets of the C layout, and its size; the bias table starts
    after it on a float's boundary."""
    text = _source()
    body = re.search(r"struct ChunkHeader \{\n(.*?)\n\};", text, re.S)
    sizes = {"uint32_t": ("u4", 4), "int32_t": ("i4", 4),
             "int64_t": ("i8", 8)}
    fields, offset = [], 0
    for ctype, names in re.findall(r"(\w+) ([\w, ]+);", body.group(1)):
        kind, size = sizes[ctype]
        for name in names.split(", "):
            offset = (offset + size - 1) // size * size
            fields.append((name, np.dtype(kind), offset))
            offset += size
    got = [(name, FT.HEADER.fields[name][0], FT.HEADER.fields[name][1])
           for name in FT.HEADER.names]
    assert got == fields
    size = re.search(r"static_assert\(sizeof\(ChunkHeader\) == (\d+)", text)
    assert int(size.group(1)) == FT.HEADER.itemsize == offset
    assert FT.header_layout(200, 1)[0] % 4 == 0


_CTYPES = {"int": ctypes.c_int, "uint32_t": ctypes.c_uint32,
           "float": ctypes.c_float}


@pytest.mark.parametrize("entry,args", [("mgt_dqn_act", FT._ACT_ARGS),
                                        ("mgt_dqn_learn_fwd", FT._FWD_ARGS),
                                        ("mgt_dqn_learn_grad", FT._GRAD_ARGS)])
def test_ctypes_signatures_are_the_c_entries(entry, args):
    """Every parameter of the three C entries, the chunk header's among
    them, has the ctypes type the launchers declare, in order."""
    m = re.search(r'extern "C" int ' + entry + r"\((.*?)\)\s*\{", _source(),
                  re.S)
    params = [p.strip() for p in m.group(1).split(",")]
    want = [ctypes.c_void_p if "*" in p or p.startswith("cudaStream_t")
            else _CTYPES[p.split()[0]] for p in params]
    assert list(args) == want
    assert sum("hdr" in p for p in params) == 1


def test_counters():
    assert set(FT.K5_KERNELS) <= set(kernels.launch_counts)
    assert set(kernels.graph_counts) == {"dqn_chunk_capture",
                                         "dqn_chunk_replay"}
    assert not set(kernels.graph_counts) & set(kernels.launch_counts)
