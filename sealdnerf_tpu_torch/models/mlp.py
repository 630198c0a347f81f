"""Bias-free MLP towers (port of sealdnerf_tpu/models/mlp.py).

An MLP is {"w": [W_0, W_1, ...]} with W_i [in, out]. The reference runs
its matmuls with bf16 inputs and f32 accumulation, and rounds each hidden
activation to bf16. Here the same rounding points are kept as
`t.to(torch.bfloat16).float()` followed by an f32 matmul, which makes the
rounding deterministic on the CPU.
"""

import math
from typing import Sequence

import torch

from ..ops.hat import bf16_round


def init_mlp(generator: torch.Generator, dims: Sequence[int]):
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) weights for dims[0] -> ... ->
    dims[-1] (torch.nn.Linear's default weight init)."""
    ws = []
    for i in range(len(dims) - 1):
        bound = 1.0 / math.sqrt(dims[i])
        u = torch.rand((dims[i], dims[i + 1]), generator=generator,
                       dtype=torch.float32)
        ws.append(u * (2.0 * bound) - bound)
    return {"w": ws}


def apply_mlp(params, x, final_activation=None, round_input: bool = True):
    """Apply the tower. round_input=False feeds x to the first matmul as
    given (the caller has already rounded what the kernel rounds)."""
    ws = params["w"]
    h = bf16_round(x) if round_input else x
    for i, w in enumerate(ws):
        h = h @ bf16_round(w.float())
        if i != len(ws) - 1:
            h = bf16_round(torch.relu(h))
    if final_activation is not None:
        h = final_activation(h)
    return h


def apply_tower(params, x, final_activation=None):
    """apply_mlp's function, with the matmuls on bf16 tensor cores where
    that gives the same numbers: on a CUDA tensor outside autograd (grid
    sweeps, frames), each hidden product comes out of a bf16 GEMM (f32
    accumulation, rounded once to bf16, which is the rounding apply_mlp
    applies after the relu: the two commute) and the last one in f32 from
    the bf16 operands. The Instant-NGP and D-NeRF towers run through it.
    Elsewhere, and wherever a gradient is taken, apply_mlp."""
    if not x.is_cuda or torch.is_grad_enabled():
        return apply_mlp(params, x, final_activation)
    ws = params["w"]
    h = x.to(torch.bfloat16)
    for w in ws[:-1]:
        h = torch.relu(h @ w.to(torch.bfloat16))
    h = h.float() @ bf16_round(ws[-1].float())
    if final_activation is not None:
        h = final_activation(h)
    return h
