"""The Q-net and the noisy dueling C51 net: initialisers, the kernels'
plain MLP, the action pick and the kernels' order of a sum.

Frozen copy of ``nn/init.py``, ``nn/mlp.py:qnet_init``, ``nn/noisy.py``,
``nn/rainbow_net.py``, ``ops/fused_mlp.py`` and ``ops/fused_actor.py`` of
``merging_gym_tpu_torch`` at commit 79f5ae92604b, with its imports of the
port replaced by the copies in this folder. Nothing here imports the port
or JAX.

Where the copy loops over slices, it now sums whole tensors in the
same order (``nets.seq_sum``); each such change keeps every product and
sum of the original and their order.
"""

from __future__ import annotations

import math

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
HIDDEN = (200, 100)  # main.py:34-38
SMEM_LIMIT = 232448  # dynamic shared memory one block can use on sm_90
NUM_ATOMS = 51              # ranbowdqn.py:32
V_MIN, V_MAX = -10.0, 10.0  # ranbowdqn.py:33-34
TRUNK = (32, 64)            # ranbowdqn.py:508-509
NOISY_LAYERS = ("noisy_value1", "noisy_value2", "noisy_advantage1",
                "noisy_advantage2")


def phi(x: float) -> float:
    return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


def greedy_threshold(epsilon: float) -> int:
    """uint32 threshold below which a Phi(eps)-greedy draw stays greedy."""
    return min(int(phi(epsilon) * 4294967296.0), 4294967295)


def select(q, mask_bits, rand_bits, greedy: bool, threshold: int):
    """First-occurrence argmax of ``q`` [N, A], or the Phi(eps)-greedy pick:
    the argmax where ``mask_bits < threshold``, else ``rand_bits % A``."""
    a = torch.argmax(q, dim=-1).to(torch.int32)
    if greedy:
        return a
    rand = (rand_bits % q.shape[-1]).to(torch.int32)
    return torch.where(mask_bits < threshold, a, rand)


def compute_dtype_of(name) -> torch.dtype:
    key = str(name).replace("torch.", "")
    if key not in _DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}")
    return _DTYPES[key]


def cast_weights(params: dict, dtype: torch.dtype, device=None) -> list:
    """``[w0, b0, w1, b1, w2, b2]`` contiguous in ``dtype``."""
    out = []
    for i in range(3):
        p = params[f"fc{i}"]
        for k in ("w", "b"):
            out.append(torch.as_tensor(p[k], device=device).to(
                torch.float32).to(dtype).contiguous())
    return out


def seq_sum(terms: torch.Tensor, dim: int, from_zero: bool = False):
    """``t_0 + t_1 + ...`` of ``terms`` along ``dim`` in index order, each
    add rounded in f32: the kernels' order (a change of this copy, which
    looped over Python slices: the reference runs in every run).

    On the card this is one ``torch.cumsum``: for a dim that is not the
    innermost of a tensor holding more than that dim, ATen scans each
    element's line one add after another in the tensor's own type
    (``scan_outer_dim``), from 0.  Elsewhere it is a loop: ATen's CPU
    cumsum accumulates f32 in f64.  ``from_zero``: the loop starts from 0
    (``0 + t_0``) as the plain versions' loops from zeros do, else from
    ``t_0``; the two differ only in the sign of an exact zero.
    """
    dim = dim % terms.dim()
    n = terms.shape[dim]
    if (terms.device.type == "cuda" and terms.dtype == torch.float32
            and dim != terms.dim() - 1 and terms.numel() != n):
        return torch.cumsum(terms, dim).select(dim, n - 1)
    acc = terms.select(dim, 0)
    if from_zero:
        acc = torch.zeros_like(acc) + acc
    for k in range(1, n):
        acc = acc + terms.select(dim, k)
    return acc


def mlp_plain_layers(weights: list, x: torch.Tensor,
                     dtype: torch.dtype) -> list:
    """The kernels' MLP, keeping every layer: ``[x, h1, h2]`` in ``dtype``
    (the input cast and the two ReLU outputs), then q f32[B, A]."""
    h = x.to(torch.float32).to(dtype)
    layers = [h]
    for i in range(3):
        w, b = weights[2 * i], weights[2 * i + 1]
        wf = w.to(torch.float32)
        acc = seq_sum(h.to(torch.float32)[:, :, None] * wf, 1)
        h = acc.to(dtype) + b
        if i < 2:
            h = torch.clamp_min(h, 0.0)
        layers.append(h)
    layers[-1] = h.to(torch.float32)
    return layers


def mlp_plain(weights: list, x: torch.Tensor, dtype: torch.dtype):
    """Plain version of the kernels' MLP: ``x`` f[B, in] -> f32[B, A]."""
    return mlp_plain_layers(weights, x, dtype)[-1]


def linear_params(generator: torch.Generator, fan_in: int, fan_out: int,
                  dtype=torch.float32, device=None, *,
                  weight_init: str = "uniform01") -> dict:
    """One dense layer ``{w: [fan_in, fan_out], b: [fan_out]}``: biases
    U(-k, k) with k = 1/sqrt(fan_in); weights U(0, 1) (``"uniform01"``, the
    reference Q-net scheme) or U(-k, k) (``"torch"``, nn.Linear's default).

    Draws come from ``generator``, on its device unless ``device`` says
    otherwise.
    """
    if device is None:
        device = generator.device
    device = torch.device(device)
    k = 1.0 / math.sqrt(fan_in)
    lo, hi = {"uniform01": (0.0, 1.0), "torch": (-k, k)}[weight_init]
    w = torch.empty(fan_in, fan_out, dtype=dtype, device=device).uniform_(
        lo, hi, generator=generator)
    b = torch.empty(fan_out, dtype=dtype, device=device).uniform_(
        -k, k, generator=generator)
    return {"w": w, "b": b}


def qnet_init(generator: torch.Generator, num_inputs: int, num_outputs: int,
              hidden=HIDDEN, dtype=torch.float32, device=None) -> dict:
    """Init the reference MLP Q-net (main.py:30-47) from ``generator``."""
    dims = (num_inputs,) + tuple(hidden) + (num_outputs,)
    return {f"fc{i}": linear_params(generator, dims[i], dims[i + 1], dtype,
                                    device)
            for i in range(len(dims) - 1)}


def noisy_init(generator: torch.Generator, in_features: int,
               out_features: int, std_init: float = 0.4,
               dtype=torch.float32, device=None) -> dict:
    """Parameter init per ranbowdqn.py:477-484: mu U(-r, r) with
    r = 1/sqrt(in), sigma filled with std_init/sqrt(fan)."""
    device = torch.device(generator.device if device is None else device)
    r = 1.0 / math.sqrt(in_features)

    def uniform(*shape):
        return torch.empty(*shape, dtype=dtype, device=device).uniform_(
            -r, r, generator=generator)

    return {
        "w_mu": uniform(in_features, out_features),
        "w_sigma": torch.full((in_features, out_features),
                              std_init / math.sqrt(in_features), dtype=dtype,
                              device=device),
        "b_mu": uniform(out_features),
        "b_sigma": torch.full((out_features,),
                              std_init / math.sqrt(out_features), dtype=dtype,
                              device=device),
    }


def scale_noise(x: torch.Tensor) -> torch.Tensor:
    """sign(x) * sqrt(|x|) (ranbowdqn.py:493-496)."""
    return torch.sign(x) * torch.sqrt(torch.abs(x))


def noisy_sample_noise(generator: torch.Generator, in_features: int,
                       out_features: int, dtype=torch.float32) -> dict:
    """Factorised noise: ``w_eps = outer(f(eps_in), f(eps_out))`` and an
    independent bias vector (ranbowdqn.py:486-491)."""
    dev = generator.device

    def draw(size):
        return scale_noise(torch.randn(size, generator=generator,
                                       dtype=dtype, device=dev))

    eps_in, eps_out = draw(in_features), draw(out_features)
    return {"w_eps": torch.outer(eps_in, eps_out), "b_eps": draw(out_features)}


def noisy_shapes(num_actions: int = 5, num_atoms: int = NUM_ATOMS) -> tuple:
    """``(name, in, out)`` of the four noisy layers."""
    h = TRUNK[1]
    return (("noisy_value1", h, h), ("noisy_value2", h, num_atoms),
            ("noisy_advantage1", h, h),
            ("noisy_advantage2", h, num_atoms * num_actions))


def rainbow_init(generator: torch.Generator, num_inputs: int,
                 num_actions: int, num_atoms: int = NUM_ATOMS,
                 std_init: float = 0.4, dtype=torch.float32,
                 device=None) -> dict:
    """Params drawn from ``generator`` (trunk first, then the four noisy
    layers in the order of :func:`noisy_shapes`)."""
    params = {
        "linear1": linear_params(generator, num_inputs, TRUNK[0], dtype,
                                 device, weight_init="torch"),
        "linear2": linear_params(generator, TRUNK[0], TRUNK[1], dtype,
                                 device, weight_init="torch"),
    }
    for name, d_in, d_out in noisy_shapes(num_actions, num_atoms):
        params[name] = noisy_init(generator, d_in, d_out, std_init, dtype,
                                  device)
    return params


def rainbow_sample_noise(generator: torch.Generator, num_actions: int,
                         num_atoms: int = NUM_ATOMS,
                         dtype=torch.float32) -> dict:
    """One noise dict for all four noisy layers (``reset_noise``,
    ranbowdqn.py:537-541)."""
    return {name: noisy_sample_noise(generator, d_in, d_out, dtype)
            for name, d_in, d_out in noisy_shapes(num_actions, num_atoms)}


def tile_size(preferred: int, f32_bytes_per_row: int,
              bytes_per_row: int) -> int:
    """Rows per block whose shared-memory tile fits the block's 227 KB."""
    per_row = f32_bytes_per_row + bytes_per_row
    tile = min(preferred, SMEM_LIMIT // per_row)
    if tile < 1:
        raise ValueError(f"a net this wide needs {per_row} B of shared "
                         f"memory per row, above the {SMEM_LIMIT} B limit")
    return tile
