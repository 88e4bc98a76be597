"""Position-wise feed-forward layers (counterpart of
``openviic_tpu/models/ffn.py``).

``PositionWiseFeedForward``: fc1 -> ReLU -> dropout -> fc2 -> dropout ->
post-LN residual (sum and LayerNorm in f32, rounded once,
``attention.residual_layer_norm``).

``MoEPositionWiseFeedForward``: the Switch top-1 mixture of experts that
``make_pwff`` builds where the attention node sets ``MOE_EXPERTS`` > 1.
The expert weights are stacked on a leading expert axis (``w1`` (E, d,
d_ff), ``b1`` (E, d_ff), ``w2`` (E, d_ff, d), ``b2`` (E, d)), the JAX
layout, which ``compat.from_jax`` carries without a transpose."""

from __future__ import annotations

import math

import torch
from torch import nn

from openviic_tpu_torch.models.attention import residual_layer_norm
from openviic_tpu_torch.models.initializers import NormalLinear, TorchLinear


class PositionWiseFeedForward(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.fc1 = TorchLinear(config.D_MODEL, config.D_FF)
        self.fc2 = TorchLinear(config.D_FF, config.D_MODEL)
        self.dropout = nn.Dropout(config.DROPOUT)
        self.dropout_2 = nn.Dropout(config.DROPOUT)
        self.layer_norm = nn.LayerNorm(config.D_MODEL, eps=1e-5)

    def forward(self, x):
        out = self.fc2(self.dropout_2(torch.relu(self.fc1(x))))
        return residual_layer_norm(self.layer_norm, x, self.dropout(out))


class MoEPositionWiseFeedForward(nn.Module):
    """Switch top-1 routing with capacity (JAX ``MoEPositionWiseFeedForward``).

    Every token of the call (T of them, padding and finished beams
    included, in row order) goes to the first-index argmax of the router's
    f32 softmax, gated by that probability.  An expert takes at most
    ``capacity = int(max(1, -(-cf * T // E)))`` tokens (cf =
    ``MOE_CAPACITY_FACTOR`` or 1.25), the first ones in row order; a token
    past its expert's capacity passes through the residual unchanged.
    The expert MLPs run batched over the expert axis in f32 (the JAX
    einsums promote the bf16 weights), and the result joins ``x`` in the
    f32 residual LayerNorm, rounded to ``x``'s dtype once.

    JAX moves rows between tokens and expert slots by one-hot (T, E, C)
    einsums; each row of those has one nonzero, so index copies and
    gathers give the same values without them (1.28 GB each at 16 000
    tokens).  A dropped token's slot is a spare row past the E x C slots,
    never read back as a slot and zero in the combine.

    ``aux_loss`` holds the last call's Switch load-balancing loss, E *
    sum_e(share of tokens routed to e * mean router probability of e),
    detached: nothing consumes it (the JAX package sows it and its
    trainer leaves it out too), and a graph held on the module would stop
    ``copy.deepcopy`` (the decode's ``ComputeShadow``).

    Under expert parallelism (``parallel.tensor_parallel.shard_model``)
    the module holds the experts ``local_experts`` only and runs them on
    the tokens routed to them; the other rows are zero and one all-reduce
    over the expert axis combines the ranks' outputs.  The routing runs
    replicated on every rank.  With dropout the experts' hidden masks are
    drawn over the rank's experts only, so they differ from one
    process's."""

    def __init__(self, config):
        super().__init__()
        d_model, d_ff = config.D_MODEL, config.D_FF
        self.n_experts = int(config.MOE_EXPERTS)
        self.capacity_factor = float(config.get("MOE_CAPACITY_FACTOR", 0) or 1.25)
        # N(0, 0.02**2), no bias: the JAX router's init
        self.router = NormalLinear(d_model, self.n_experts, bias=False)
        e = self.n_experts
        self.w1 = nn.Parameter(torch.empty(e, d_model, d_ff))
        self.b1 = nn.Parameter(torch.empty(e, d_ff))
        self.w2 = nn.Parameter(torch.empty(e, d_ff, d_model))
        self.b2 = nn.Parameter(torch.empty(e, d_model))
        self.dropout = nn.Dropout(config.DROPOUT)
        self.dropout_2 = nn.Dropout(config.DROPOUT)
        self.layer_norm = nn.LayerNorm(d_model, eps=1e-5)
        self.aux_loss = None
        # expert parallel (parallel/tensor_parallel.py): the [first, last)
        # experts whose weights this rank holds, and (mesh, axis)
        self.local_experts = (0, e)
        self.expert_parallel = None

    def reset_with(self, generator: torch.Generator) -> None:
        """Per-expert ``nn.Linear`` draws, U(+-1/sqrt(fan_in)) for kernel
        and bias (the JAX ``_stacked_linear_kernel`` / ``_bias``)."""
        for param, fan_in in ((self.w1, self.w1.shape[1]), (self.b1, self.w1.shape[1]),
                              (self.w2, self.w2.shape[1]), (self.b2, self.w2.shape[1])):
            bound = 1.0 / math.sqrt(fan_in)
            param.uniform_(-bound, bound, generator=generator)

    def capacity(self, n_tokens: int) -> int:
        return int(max(1, -(-self.capacity_factor * n_tokens // self.n_experts)))

    def forward(self, x):
        d = x.shape[-1]
        xf = x.reshape(-1, d).float()
        n_tokens, e = xf.shape[0], self.n_experts
        capacity = self.capacity(n_tokens)

        probs = torch.softmax(nn.functional.linear(xf, self.router.weight.float()), dim=-1)
        expert = probs.argmax(dim=-1)  # first index on ties
        gate = probs.gather(1, expert[:, None])[:, 0]
        onehot = nn.functional.one_hot(expert, e)
        position = onehot.cumsum(dim=0).gather(1, expert[:, None])[:, 0] - 1
        spare = e * capacity
        slot = torch.where(position < capacity, expert * capacity + position, spare)
        self.aux_loss = (e * torch.sum(onehot.float().mean(dim=0) * probs.mean(dim=0))).detach()

        xin, gate_in = xf, gate
        if self.expert_parallel is not None:  # the replicated inputs of this rank's experts
            from openviic_tpu_torch.parallel import collectives

            xin, gate_in = (collectives.copy_to(t, *self.expert_parallel) for t in (xf, gate))
        xe = xin.new_zeros((spare + 1, d)).index_copy(0, slot, xin)[:spare]
        first, last = self.local_experts
        xe = xe.reshape(e, capacity, d)[first:last]
        h = torch.relu(torch.bmm(xe, self.w1.float()) + self.b1.float()[:, None, :])
        h = self.dropout_2(h)
        ye = torch.bmm(h, self.w2.float()) + self.b2.float()[:, None, :]
        ye = torch.cat([ye.new_zeros((first * capacity, d)), ye.reshape(-1, d),
                        ye.new_zeros(((e - last) * capacity + 1, d))])
        out = gate_in[:, None] * ye[slot]
        if self.expert_parallel is not None:  # the combine: each token from its expert's rank
            out = collectives.all_reduce(out, *self.expert_parallel)
        out = self.dropout(out)
        return residual_layer_norm(self.layer_norm, x, out.reshape(x.shape))


def make_pwff(config) -> nn.Module:
    """The Switch MoE FFN where ``MOE_EXPERTS`` > 1, else the dense one."""
    if int(config.get("MOE_EXPERTS", 0) or 0) > 1:
        return MoEPositionWiseFeedForward(config)
    return PositionWiseFeedForward(config)
