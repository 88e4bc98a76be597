"""Tensor parallelism over the mesh's ``model`` axis and expert parallelism
over its ``expert`` axis (the port's counterparts of ``_TP_RULES``,
``_EP_RULES`` and ``param_shardings`` in ``openviic_tpu/parallel/mesh.py``).

**The rule tables** state JAX's in the port's parameter names.  A Flax
kernel is (in, out) and a torch ``Linear.weight`` (out, in), so JAX's
``P(None, "model")`` on a kernel is ``("model", None)`` on the weight: the
output dim.  A spec is a tuple of axis names or None, one per leading dim;
``()`` is replicated.

 - column-parallel ``fc_q``, ``fc_k``, ``fc_v``, ``fc_s`` (weights and
   biases) and the FFN's ``fc1``: each rank computes its slice of the
   outputs; for the attention, its h / P heads;
 - row-parallel ``fc_o`` and the FFN's ``fc2``: each rank multiplies its
   slice of the inputs, the partial products are all-reduced, then the
   (replicated) bias is added;
 - the decoder's ``fc`` sharded over the vocab: each rank holds V / P
   rows.  Its ``local`` product gives the rank's logits; its ``forward``
   all-gathers them (a caller that wants log-probs over the vocab gets
   them right), while the XE step (``vocab_parallel_nll_sum``: a max and a
   sum-of-exp all-reduce, the target's logit from the rank that holds it)
   and the decode (``vocab_parallel_topk``: each rank's top-k and lse,
   merged) never build the full (rows, V) logits;
 - the Switch MoE FFN's stacked ``w1``, ``b1``, ``w2``, ``b2`` over their
   leading expert axis: each rank runs its E / P experts on the tokens
   routed to them; the router stays replicated, and so do the capacity,
   the pass-through and the aux loss; the combine is one all-reduce.

Each rank keeps only its shard of a sharded parameter (``shard_model``)
and of the optimizer tensors shaped like it (``shard_optimizer_state``).
The rules match parameter names, as JAX's match paths, so every family is
sharded: each ``Linear`` whose weight a rule shards becomes the column-,
row- or vocab-parallel linear below, whatever module holds it (an
attention's ``fc_q``, RSTNet's ``fc_s`` and its language model's
``encoder_layer``); what no rule matches stays whole on every rank (AoA's
gates, the memory slots, M²'s ``fc_alpha_*``, CAMO's MLP, the ORT's and
DLCT's ``fc_gs``, the language model's backbone, a Switch MoE FFN under
``model`` alone).  An attention whose head count the axis divides attends
with its h / P heads (its memory slots' and geometry's columns of those
heads, ``head_parallel``); one whose head count the axis does not divide
(CAMO's one-head encoder attention) keeps JAX's layout: q, k and v come
out column-sharded and are all-gathered to whole heads, every rank
attends all of them, and the row-parallel ``fc_o`` multiplies the rank's
columns of the output (``gathered_heads``).  A flattened width, FFN width
or vocab that the axis does not divide is refused with a ``ValueError``
naming the weight, as JAX refuses to place such an array."""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from openviic_tpu_torch.ops.head_topk import head_topk
from openviic_tpu_torch.parallel import collectives

Spec = Tuple[Optional[str], ...]

TP_RULES = [
    (re.compile(r"(fc_q|fc_k|fc_v|fc_s)\.weight$"), ("model", None)),
    (re.compile(r"(fc_q|fc_k|fc_v|fc_s)\.bias$"), ("model",)),
    (re.compile(r"fc_o\.weight$"), (None, "model")),
    (re.compile(r"pwff\.fc1\.weight$"), ("model", None)),
    (re.compile(r"pwff\.fc1\.bias$"), ("model",)),
    (re.compile(r"pwff\.fc2\.weight$"), (None, "model")),
    # the big vocab projection: shard the vocab dim
    (re.compile(r"decoder\.fc\.weight$"), ("model", None)),
]

EP_RULES = [
    (re.compile(r"pwff\.(w1|w2)$"), ("expert", None, None)),
    (re.compile(r"pwff\.(b1|b2)$"), ("expert", None)),
]


def param_shardings(model: nn.Module, mesh) -> Dict[str, Spec]:
    """{parameter name: spec}: the TP rules where the mesh has a ``model``
    axis, the EP rules where it has an ``expert`` axis, first match wins,
    a spec longer than the parameter's rank skipped (JAX's rank guard);
    ``()`` elsewhere."""
    rules = []
    if "model" in mesh.axis_names:
        rules += TP_RULES
    if "expert" in mesh.axis_names:
        rules += EP_RULES

    def spec_for(name: str, param) -> Spec:
        for pattern, spec in rules:
            if pattern.search(name) and len(spec) <= param.dim():
                return spec
        return ()

    return {name: spec_for(name, p) for name, p in model.named_parameters()}


def local_shard(tensor: torch.Tensor, spec: Spec, mesh, name: str = "") -> torch.Tensor:
    """This rank's block of ``tensor`` under ``spec``; raises a ``ValueError``
    naming ``name`` and the axis where the axis does not divide the dim."""
    out = tensor
    for dim, axis in enumerate(spec):
        if axis is None or mesh.axis_size(axis) == 1:
            continue
        n, size = mesh.axis_size(axis), out.shape[dim]
        if size % n:
            raise ValueError(f"{name}: dim {dim} of size {size} not divisible by mesh axis "
                             f"'{axis}' of size {n}")
        out = out.narrow(dim, mesh.index(axis) * (size // n), size // n)
    return out


class _ParallelLinear(nn.Module):
    """A linear layer holding the rank's shard of a ``Linear``'s parameters
    (the same ``Parameter`` objects, so an optimizer built on the model
    keeps them); computed in the promoted dtype of the input and the
    weights, as ``models.attention.promoted_linear`` computes one."""

    promotes = True  # promoted_linear calls the module itself

    def __init__(self, linear: nn.Linear, mesh, axis: str = "model"):
        super().__init__()
        self.weight, self.bias = linear.weight, linear.bias
        self.mesh, self.axis = mesh, axis

    def _product(self, x, bias):
        dtype = torch.promote_types(x.dtype, self.weight.dtype)
        return nn.functional.linear(x.to(dtype), self.weight.to(dtype),
                                    None if bias is None else bias.to(dtype))


class ColumnParallelLinear(_ParallelLinear):
    """The rank's slice of the outputs (its rows of the weight and bias)."""

    def forward(self, x):
        return self._product(collectives.copy_to(x, self.mesh, self.axis), self.bias)


class RowParallelLinear(_ParallelLinear):
    """The rank's slice of the inputs (its columns of the weight); the
    partial products all-reduced, then the bias added.  The partial
    products and their sum stay in f32 and round to the compute dtype
    once, as one process's bf16 product accumulates in f32 and rounds
    once (a bf16 partial sum would round twice more)."""

    def forward(self, x):
        dtype = torch.promote_types(x.dtype, self.weight.dtype)
        out = nn.functional.linear(x.float(), self.weight.float())
        out = collectives.all_reduce(out, self.mesh, self.axis)
        if self.bias is not None:
            out = out + self.bias.float()
        return out.to(dtype)


class VocabParallelLinear(ColumnParallelLinear):
    """The vocab head over the rank's V / P ids: ``local`` gives its logits,
    ``forward`` the full logits (all-gathered)."""

    def local(self, x):
        return ColumnParallelLinear.forward(self, x)

    def forward(self, x):
        return collectives.all_gather(self.local(x), self.mesh, self.axis, x.dim() - 1)


def _cut(param: nn.Parameter, spec: Spec, mesh, name: str) -> None:
    with torch.no_grad():
        param.data = local_shard(param.data, spec, mesh, name).clone()


def _parallel_linears(model: nn.Module, specs: Dict[str, Spec], mesh) -> None:
    """Swap each ``Linear`` whose weight a model-axis rule shards for the
    parallel linear of its spec: the output dim sharded, column-parallel
    (the decoder's vocab head, vocab-parallel); the input dim, row-parallel."""
    swaps = []
    for name, module in model.named_modules():
        for child_name, child in module.named_children():
            full = f"{name}.{child_name}" if name else child_name
            spec = specs.get(f"{full}.weight")
            if not isinstance(child, nn.Linear) or "model" not in (spec or ()):
                continue
            if spec == (None, "model"):
                cls = RowParallelLinear
            else:
                cls = VocabParallelLinear if full.endswith("decoder.fc") else ColumnParallelLinear
            swaps.append((module, child_name, cls(child, mesh)))
    for module, child_name, linear in swaps:
        setattr(module, child_name, linear)


def _head_layouts(model: nn.Module, mesh) -> None:
    """Each sharded attention on the rank's h / P heads (``head_parallel``)
    where the axis divides its heads, else on whole heads gathered
    (``gathered_heads``); the geometric encoders' ``fc_gs`` on the heads of
    their attentions, which share their head count."""
    from openviic_tpu_torch.models.attention import _Projections

    tp, axis = mesh.axis_size("model"), (mesh, "model")
    for module in model.modules():
        if isinstance(module, _Projections) and isinstance(module.fc_q, ColumnParallelLinear):
            if module.h % tp:
                module.gathered_heads = axis
            else:
                module.h //= tp
                module.head_parallel = axis
        elif hasattr(module, "fc_gs") and module.n_heads % tp == 0:
            module.head_parallel = axis


def shard_model(model: nn.Module, mesh) -> Dict[str, Spec]:
    """Keep each matched parameter's shard only (in place, the same
    ``Parameter`` objects) and make the modules compute on it: under a
    ``model`` axis of size > 1 the column-, row- and vocab-parallel linears
    and each attention on its heads' share (see the module's docstring);
    under an ``expert`` axis of size > 1 each Switch MoE FFN on its E / P
    experts.  Returns ``param_shardings(model, mesh)`` as it was before
    the cut.  The model records the mesh (``model.parallel_mesh``); a
    second call does nothing."""
    from openviic_tpu_torch.models.ffn import MoEPositionWiseFeedForward

    if getattr(model, "parallel_mesh", None) is not None:
        return model.parallel_specs
    specs = param_shardings(model, mesh)
    tp, ep = mesh.axis_size("model"), mesh.axis_size("expert")
    names = {id(p): n for n, p in model.named_parameters()}
    # every refusal before anything is cut
    for module in model.modules():
        if ep > 1 and isinstance(module, MoEPositionWiseFeedForward) and module.n_experts % ep:
            raise ValueError(f"{names[id(module.w1)]}: {module.n_experts} experts not "
                             f"divisible by mesh axis 'expert' of size {ep}")
    for name, p in model.named_parameters():
        local_shard(p.data, specs[name], mesh, name)
    if tp > 1:
        _parallel_linears(model, specs, mesh)
        _head_layouts(model, mesh)
    if ep > 1:
        for module in model.modules():
            if isinstance(module, MoEPositionWiseFeedForward):
                per = module.n_experts // ep
                first = mesh.index("expert") * per
                module.local_experts = (first, first + per)
                module.expert_parallel = (mesh, "expert")
    for name, p in model.named_parameters():
        if any(a is not None and mesh.axis_size(a) > 1 for a in specs[name]):
            _cut(p, specs[name], mesh, name)
    model.parallel_mesh, model.parallel_specs = mesh, specs
    return specs


def shard_optimizer_state(model: nn.Module, optimizer, specs: Dict[str, Spec], mesh) -> None:
    """Cut every optimizer tensor that is shaped like a sharded parameter's
    full tensor (Adam's moments, a momentum buffer) to the parameter's
    shard, in place; the others (the step count) stay replicated."""
    for name, p in model.named_parameters():
        state = optimizer.state.get(p)
        if not state or not specs.get(name):
            continue
        for key, value in list(state.items()):
            if torch.is_tensor(value) and value.dim() == p.dim() and value.shape != p.shape:
                state[key] = local_shard(value, specs[name], mesh, name).clone()


def full_tensors(tensors: Dict[str, torch.Tensor], model: nn.Module, mesh
                 ) -> Dict[str, torch.Tensor]:
    """``tensors`` (by parameter name: the parameters, their gradients) of a
    sharded ``model`` made whole: each sharded one all-gathered along its
    sharded dims (collectively: every rank of the axes calls it); on the
    CPU."""
    specs = getattr(model, "parallel_specs", {})
    out = {}
    with torch.no_grad():
        for name, t in tensors.items():
            for dim, axis in enumerate(specs.get(name, ())):
                if axis is not None and mesh.axis_size(axis) > 1:
                    t = collectives.all_gather(t, mesh, axis, dim)
            out[name] = t.cpu()
    return out


def whole_linear(linear: nn.Module):
    """(weight, bias) of ``linear`` made whole, detached: a parallel
    linear's shards all-gathered over its axis (collectively: every rank of
    the axis calls it), a plain ``Linear``'s as they are."""
    weight, bias = linear.weight.detach(), linear.bias
    bias = None if bias is None else bias.detach()
    if isinstance(linear, ColumnParallelLinear):
        weight = collectives.all_gather(weight, linear.mesh, linear.axis, 0)
        bias = None if bias is None else collectives.all_gather(bias, linear.mesh, linear.axis, 0)
    elif isinstance(linear, RowParallelLinear):
        weight = collectives.all_gather(weight, linear.mesh, linear.axis, 1)
    return weight, bias


def vocab_parallel_nll_sum(logits: torch.Tensor, targets: torch.Tensor, ignore_index: int,
                           mesh, axis: str = "model") -> torch.Tensor:
    """``nll_sum`` of the log-softmax over the whole vocab, from this rank's
    (..., V / P) f32 logits of its vocab shard: the global max and sum of
    exps by two all-reduces, the target's logit from the rank that holds
    it (zeros elsewhere, all-reduced).  Replicated over the axis."""
    v_local = logits.shape[-1]
    first = mesh.index(axis) * v_local
    flat = logits.reshape(-1, v_local)
    t = targets.reshape(-1).long()
    m = collectives.all_reduce_max(flat.detach().amax(dim=-1), mesh, axis)
    sumexp = collectives.all_reduce(torch.exp(flat - m[:, None]).sum(dim=-1), mesh, axis)
    lse = torch.log(sumexp) + m
    local_t = t - first
    own = (local_t >= 0) & (local_t < v_local)
    picked = torch.gather(flat, 1, local_t.clamp(0, v_local - 1)[:, None])[:, 0]
    picked = collectives.all_reduce(torch.where(own, picked, torch.zeros_like(picked)), mesh,
                                    axis)
    nll = lse - picked
    return torch.where(t != ignore_index, nll, torch.zeros_like(nll)).sum()


def merge_shard_topk(vals: torch.Tensor, ids: torch.Tensor, lses: torch.Tensor, k: int):
    """The exact top-k of a row over the whole vocab from each shard's:
    ``vals``/``ids`` (N, P * k) each shard's top-k (value descending, ties
    to the lowest id) with global ids, concatenated in shard order;
    ``lses`` (N, P) each shard's logsumexp.  Returns (vals (N, k), ids (N,
    k), lse (N,)), ordered by value descending and id ascending: a stable
    sort of the candidates, whose shard order puts lower ids first (never
    ``torch.topk``, which promises no tie order)."""
    order = torch.sort(vals, dim=1, descending=True, stable=True).indices[:, :k]
    return (torch.gather(vals, 1, order), torch.gather(ids, 1, order),
            torch.logsumexp(lses, dim=1))


def vocab_parallel_topk(hidden: torch.Tensor, head: VocabParallelLinear, k: int,
                        kernel: bool = False):
    """Per row of ``hidden`` (N, d): the k largest logits over the whole
    vocab (raw), their ids and the row's logsumexp, from each rank's shard
    of the head: with ``kernel`` the ``head_topk`` kernel on the shard (the
    plain version on the CPU), else the shard's f32 logits, a stable sort
    and their logsumexp; then ``merge_shard_topk`` of the gathered shard
    results.  (vals f32, ids int64, lse f32)."""
    mesh, axis = head.mesh, head.axis
    v_local = head.weight.shape[0]
    if kernel:
        vals, ids, lse = head_topk(hidden.to(torch.bfloat16).contiguous(),
                                   head.weight.to(torch.bfloat16).contiguous(), k)
    else:
        logits = head.local(hidden).float()
        lse = torch.logsumexp(logits, dim=-1)
        vals, ids = torch.sort(logits, dim=-1, descending=True, stable=True)
        vals, ids = vals[:, :k], ids[:, :k]
    ids = ids.long() + mesh.index(axis) * v_local
    return merge_shard_topk(collectives.all_gather(vals, mesh, axis, 1),
                            collectives.all_gather(ids, mesh, axis, 1),
                            collectives.all_gather(lse[:, None], mesh, axis, 1), k)
