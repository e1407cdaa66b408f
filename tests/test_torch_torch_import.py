"""Reference ``.pth`` import of the PyTorch port (``io.torch_import``)
against the JAX package's, and the CLI's use of reference run directories.

The reference directories are written here, with the JAX package's
``qnet_to_state_dict`` and ``torch.save`` (``eval.pth``/``target.pth`` of a
DQN run, scripts/main.py:244-245; ``meta_eval.pth``/``meta_target.pth`` of
an h-DQN run, hdqn.py:362-366); a Rainbow state dict carries the
reference's module names (ranbowdqn.py:508-515) and its noise buffers.
Both packages' loaders must give equal arrays, and ``eval``/``train
--opponent`` of a directory must equal the same command on the same net's
``params.npz``.
"""

import functools
import os

import jax
import numpy as np
import pytest
import torch

from merging_gym_tpu.io import torch_import as JTI
from merging_gym_tpu.nn.mlp import qnet_init as jax_qnet_init
from merging_gym_tpu.nn.rainbow_net import rainbow_init as jax_rainbow_init
from merging_gym_tpu_torch import cli
from merging_gym_tpu_torch.agents import evaluate as E
from merging_gym_tpu_torch.io import torch_import as TI
from merging_gym_tpu_torch.io.checkpoint import (load_params_npz,
                                                 save_params_npz)
from merging_gym_tpu_torch.nn.mlp import qnet_params_from_numpy
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZOO = os.path.join(REPO, "model_zoo")
CPU = torch.device("cpu")


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x), tree)


def _assert_equal_trees(got, want):
    assert sorted(got) == sorted(want)
    for layer in want:
        assert sorted(got[layer]) == sorted(want[layer]), layer
        for k, w in want[layer].items():
            g = got[layer][k]
            assert g.device == CPU and g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"{layer}.{k}")


def _write_reference_dqn(path, eval_net, target_net):
    os.makedirs(path, exist_ok=True)
    torch.save(JTI.qnet_to_state_dict(eval_net), os.path.join(path,
                                                              "eval.pth"))
    torch.save(JTI.qnet_to_state_dict(target_net),
               os.path.join(path, "target.pth"))


def _write_reference_hdqn(path, seed):
    nets = {"eval": jax_qnet_init(jax.random.key(seed), 11, 5),
            "target": jax_qnet_init(jax.random.key(seed + 1), 11, 5),
            "meta_eval": jax_qnet_init(jax.random.key(seed + 2), 10, 3),
            "meta_target": jax_qnet_init(jax.random.key(seed + 3), 10, 3)}
    os.makedirs(path, exist_ok=True)
    for name, net in nets.items():
        torch.save(JTI.qnet_to_state_dict(net),
                   os.path.join(path, f"{name}.pth"))
    return nets


def test_reference_dqn_loads_as_in_jax(tmp_path):
    _write_reference_dqn(tmp_path, jax_qnet_init(jax.random.key(0), 10, 5),
                         jax_qnet_init(jax.random.key(1), 10, 5))
    want = JTI.load_reference_dqn(str(tmp_path))
    got = TI.load_reference_dqn(str(tmp_path), CPU)
    for g, w in zip(got, want):
        _assert_equal_trees(g, w)
    _assert_equal_trees(TI.load_qnet_pth(str(tmp_path / "eval.pth"), CPU),
                        want[0])


def test_reference_hdqn_loads_as_in_jax(tmp_path):
    _write_reference_hdqn(str(tmp_path), 3)
    want = JTI.load_reference_hdqn(str(tmp_path))
    got = TI.load_reference_hdqn(str(tmp_path), CPU)
    assert sorted(got) == sorted(want)
    for k in want:
        _assert_equal_trees(got[k], want[k])
    assert tuple(got["meta_eval"]["fc2"]["w"].shape) == (100, 3)
    assert tuple(got["lower_eval"]["fc0"]["w"].shape) == (11, 200)


@pytest.mark.parametrize("hidden", [(200, 100), (64, 32)])
def test_qnet_state_dict_round_trip_and_jax_export(hidden):
    params = _np(jax_qnet_init(jax.random.key(7), 10, 5, hidden))
    sd = TI.qnet_to_state_dict(qnet_params_from_numpy(params, CPU))
    want = JTI.qnet_to_state_dict(params)
    assert sorted(sd) == sorted(want)
    for k in want:
        assert sd[k].is_contiguous()
        assert torch.equal(sd[k], want[k]), k
    _assert_equal_trees(TI.qnet_from_state_dict(sd, CPU), params)
    # numpy params export the same way.
    assert all(torch.equal(TI.qnet_to_state_dict(params)[k], want[k])
               for k in want)


def _reference_rainbow_state_dict(params, seed):
    """A ``RainbowDQN`` state dict: ``nn.Linear`` weights ``[out, in]``,
    the noisy layers' mu and sigma, and their epsilon buffers."""
    rng = np.random.default_rng(seed)
    sd = {}
    for name, p in params.items():
        if "w" in p:
            sd[f"{name}.weight"] = torch.tensor(np.asarray(p["w"]).T.copy())
            sd[f"{name}.bias"] = torch.tensor(np.asarray(p["b"]))
            continue
        for k, ref in (("w_mu", "weight_mu"), ("w_sigma", "weight_sigma")):
            sd[f"{name}.{ref}"] = torch.tensor(np.asarray(p[k]).T.copy())
        for k, ref in (("b_mu", "bias_mu"), ("b_sigma", "bias_sigma")):
            sd[f"{name}.{ref}"] = torch.tensor(np.asarray(p[k]))
        sd[f"{name}.weight_epsilon"] = torch.tensor(rng.standard_normal(
            np.asarray(p["w_mu"]).T.shape).astype(np.float32))
        sd[f"{name}.bias_epsilon"] = torch.tensor(rng.standard_normal(
            np.asarray(p["b_mu"]).shape).astype(np.float32))
    return sd


def test_rainbow_pth_loads_as_in_jax(tmp_path):
    params = _np(jax_rainbow_init(jax.random.key(5), 10, 5))
    path = str(tmp_path / "eval_net.pth")
    torch.save(_reference_rainbow_state_dict(params, 5), path)
    want = JTI.load_rainbow_pth(path)
    got = TI.load_rainbow_pth(path, CPU)
    _assert_equal_trees(got, want)
    _assert_equal_trees(got, params)
    _assert_equal_trees(TI.rainbow_from_state_dict(torch.load(path), CPU),
                        want)


@pytest.fixture(scope="module")
def l2_run_dir(tmp_path_factory):
    """model_zoo/L2's net as a reference run directory, written by the
    port's ``qnet_to_state_dict``."""
    path = str(tmp_path_factory.mktemp("ref_l2"))
    net = qnet_params_from_numpy(load_params_npz(os.path.join(
        ZOO, "L2", "params.npz")), CPU)
    for name in ("eval.pth", "target.pth"):
        torch.save(TI.qnet_to_state_dict(net), os.path.join(path, name))
    return path


@pytest.mark.parametrize("fused", [False, True], ids=["eval", "eval_fused"])
def test_eval_of_a_run_dir_equals_eval_of_its_npz(monkeypatch, l2_run_dir,
                                                  fused):
    # The plain K6 on one CPU thread: 200 of evaluate_fused's 2,600 steps.
    monkeypatch.setattr(E, "evaluate_fused",
                        functools.partial(E.evaluate_fused, num_steps=200))
    args = ["--cpu", "eval", "--p2", os.path.join(ZOO, "L1", "params.npz"),
            "--num-envs", "16", "--episodes", "16", "--max-steps", "100",
            "--seed", "3", *(["--fused"] if fused else [])]
    got = cli.main([*args, "--p1", l2_run_dir])
    want = cli.main([*args, "--p1", os.path.join(ZOO, "L2", "params.npz")])
    assert got == want and want["episodes"] >= 16


def test_eval_of_a_dir_without_eval_pth_is_refused(tmp_path):
    with pytest.raises(SystemExit, match="cannot load"):
        cli.main(["--cpu", "eval", "--p1", str(tmp_path)])


def _train(tmp_path, name, algo, opponent, *flags):
    out = str(tmp_path / name)
    cli.main(["--cpu", "train", "--algo", algo, "--opponent", opponent,
              "--num-envs", "16", "--chunk-steps", "3", "--max-chunks", "1",
              "--memory-capacity", "32", "--batch-size", "8",
              "--episodes", "1000000", "--out", out, *flags])
    return load_params_npz(os.path.join(out, "params.npz"))


def _assert_equal_npz(got, want):
    for k, v in want.items():
        if isinstance(v, dict):
            _assert_equal_npz(got[k], v)
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("algo", ["dqn", "rainbow"])
def test_train_against_a_reference_run_dir(tmp_path, l2_run_dir, algo):
    """One chunk against the frozen reference net equals one chunk against
    the same net's params.npz."""
    got = _train(tmp_path, "dir", algo, l2_run_dir)
    want = _train(tmp_path, "npz", algo,
                  os.path.join(ZOO, "L2", "params.npz"))
    _assert_equal_npz(got, want)


def test_train_hdqn_against_a_reference_hdqn_run_dir(tmp_path):
    nets = _write_reference_hdqn(str(tmp_path / "ref"), 11)
    npz = str(tmp_path / "ref.npz")
    save_params_npz(npz, {"upper": _np(nets["meta_eval"]),
                          "lower": _np(nets["eval"])})
    got = _train(tmp_path, "dir", "hdqn", str(tmp_path / "ref"),
                 "--goal-memory-capacity", "16")
    want = _train(tmp_path, "npz", "hdqn", npz, "--goal-memory-capacity",
                  "16")
    _assert_equal_npz(got, want)
