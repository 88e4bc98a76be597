"""XE and SCST training steps and the evaluation step (the port's
counterpart of ``openviic_tpu/training/steps.py``).

The step state is a dict: ``params`` (the model's f32 master parameters by
name), ``optimizer``, ``scheduler`` (or None), ``step`` and ``generator``,
an explicit ``torch.Generator`` that draws each update's dropout seed.
The forward and backward run under a fork of the global RNG seeded from
it (``rng.fork``), so a run is reproducible from its seed and its state,
and the global RNG is left as it was.  Dropout is on inside the step
(``model.train()``) and the model's mode is restored after it.  After a
step each parameter's ``.grad`` holds that update's gradient.

Mixed precision follows the JAX package, not ``torch.autocast``: the model
runs through ``torch.func.functional_call`` on bf16 casts of the master
parameters and of the batch's floating fields, and the casts are
differentiated, so gradients reach the f32 parameters in f32."""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from openviic_tpu_torch import rng

Batch = Dict[str, torch.Tensor]


def nll_loss(log_probs: torch.Tensor, targets: torch.Tensor, ignore_index: int) -> torch.Tensor:
    """Mean negative log-likelihood over the targets that are not
    ``ignore_index`` (``NLLLoss(ignore_index=...)``: the sum over kept
    positions over their count)."""
    flat_lp = log_probs.reshape(-1, log_probs.shape[-1])
    flat_t = targets.reshape(-1).long()
    keep = flat_t != ignore_index
    picked = torch.gather(flat_lp, 1, flat_t[:, None])[:, 0]
    picked = torch.where(keep, picked, torch.zeros_like(picked))
    return -picked.sum() / keep.sum().clamp_min(1)


def fused_nll(logits: torch.Tensor, targets: torch.Tensor, ignore_index: int) -> torch.Tensor:
    """Mean NLL straight from raw head logits, without a log-softmax tensor:
    per kept position ``lse(logits) - logits[target]``.  The max shift is
    detached (its gradient cancels), and both terms are upcast to f32
    before the subtraction, as the f32 log-softmax computes them."""
    m = logits.detach().amax(dim=-1, keepdim=True).float()
    lse = m[..., 0] + torch.log(torch.exp(logits.float() - m).sum(dim=-1))
    targets = targets.long()
    picked = torch.gather(logits, -1, targets[..., None])[..., 0].float()
    keep = targets != ignore_index
    per_pos = torch.where(keep, lse - picked, torch.zeros_like(lse))
    return per_pos.sum() / keep.sum().clamp_min(1)


def label_smoothing_loss(log_probs: torch.Tensor, targets: torch.Tensor, ignore_index: int,
                         smoothing: float = 0.1) -> torch.Tensor:
    """KL-divergence label smoothing: ``1 - smoothing`` on the gold token,
    ``smoothing`` spread over the rest of the vocabulary but pad; ignored
    positions contribute 0."""
    vocab = log_probs.shape[-1]
    flat_lp = log_probs.reshape(-1, vocab)
    flat_t = targets.reshape(-1).long()
    keep = flat_t != ignore_index
    fill = smoothing / (vocab - 2)  # excludes the gold token and pad
    true_dist = torch.full_like(flat_lp, fill)
    true_dist[:, ignore_index] = 0.0
    gold = torch.nn.functional.one_hot(flat_t, vocab).bool()
    true_dist = torch.where(gold, torch.full_like(true_dist, 1.0 - smoothing), true_dist)
    kl = true_dist * (torch.log(true_dist.clamp_min(1e-12)) - flat_lp)
    per_pos = torch.where(keep, kl.sum(-1), torch.zeros_like(flat_lp[:, 0]))
    return per_pos.sum() / keep.sum().clamp_min(1)


def init_xe_state(model: torch.nn.Module, optimizer, scheduler=None, seed: int = 0) -> dict:
    """The step state for ``model``'s parameters under ``optimizer`` (and its
    ``scheduler``), with the dropout generator seeded from ``seed``."""
    return {"params": dict(model.named_parameters()), "optimizer": optimizer,
            "scheduler": scheduler, "step": 0,
            "generator": torch.Generator().manual_seed(seed)}


def _cast_floating(batch: Batch, dtype) -> Batch:
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in batch.items()}


def _train_update(model, state: dict, backward, stream=None):
    """One update of ``state``: ``backward()`` (which fills the gradients
    and returns the loss) in train mode on the dropout stream drawn from
    the state's generator (folded with ``stream`` where one is given: a
    rank's), then the optimizer's (and scheduler's) step.  Returns (state,
    the loss detached)."""
    seed = rng.draw_seed(state["generator"])
    if stream is not None:
        seed = rng.fold_in(seed, stream)
    device = next(model.parameters()).device
    was_training = model.training
    optimizer = state["optimizer"]
    optimizer.zero_grad(set_to_none=True)
    model.train()
    try:
        with rng.fork(device):
            rng.reseed(seed, device)
            loss = backward()
    finally:
        model.train(was_training)
    optimizer.step()
    if state.get("scheduler") is not None:
        state["scheduler"].step()
    state["step"] += 1
    return state, loss.detach()


def make_xe_step(model, label_smoothing: float = 0.0, mixed_precision: bool = False,
                 grad_accum: int = 1):
    """(state, batch) -> (state, loss): one XE update of ``model``.

    ``mixed_precision``: the forward and backward in bf16 against the f32
    master parameters.  ``grad_accum``: the batch split into that many
    microbatches along dim 0 (it must divide the batch), their gradients
    summed before the one update, each microbatch's mean loss weighted by
    its non-pad token count, so that the result equals the full batch's.
    ``label_smoothing`` > 0 takes ``label_smoothing_loss`` over the
    log-probs instead of ``fused_nll`` over the logits."""
    pad = model.vocab.padding_idx

    def loss_terms(mb: Batch):
        """(sum of per-token losses, token count) for one microbatch."""
        targets = mb["shifted_right_caption_tokens"]
        count = (targets != pad).sum().clamp_min(1)
        if mixed_precision:
            params = {name: p.to(torch.bfloat16) for name, p in model.named_parameters()}
            out = torch.func.functional_call(
                model, params, (_cast_floating(mb, torch.bfloat16),),
                {"raw_logits": label_smoothing <= 0.0})
        else:
            out = model(mb, raw_logits=label_smoothing <= 0.0)
        if label_smoothing > 0.0:
            mean = label_smoothing_loss(out, targets, pad, smoothing=label_smoothing)
        else:
            mean = fused_nll(out, targets, pad)
        return mean * count, count

    def update(state: dict, batch: Batch):
        def backward():
            if grad_accum <= 1:
                total, count = loss_terms(batch)
                loss = total / count
                loss.backward()
                return loss
            micro = {k: v.chunk(grad_accum) for k, v in batch.items()}
            if any(len(v) != grad_accum or v[0].shape != v[-1].shape
                   for v in micro.values()):
                raise ValueError(f"grad_accum {grad_accum} must divide the batch")
            total, count = 0.0, 0
            for i in range(grad_accum):
                mb_total, mb_count = loss_terms({k: v[i] for k, v in micro.items()})
                mb_total.backward()
                total, count = total + mb_total.detach(), count + mb_count
            # grads of (mean * count) summed over the total count equal the
            # full batch's gradient
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.div_(count)
            return total / count

        return _train_update(model, state, backward)

    return update


def make_xe_multi_step(model, label_smoothing: float = 0.0, mixed_precision: bool = False):
    """(state, (batch, ...)) -> (state, losses (k,)): k sequential XE updates
    in one call, numerically k calls of ``make_xe_step``'s update."""
    update = make_xe_step(model, label_smoothing, mixed_precision)

    def xe_multi_step(state: dict, batches: Sequence[Batch]):
        losses = []
        for batch in batches:
            state, loss = update(state, batch)
            losses.append(loss)
        return state, torch.stack(losses)

    return xe_multi_step


def make_eval_loss_step(model):
    """batch -> mean NLL of the teacher-forced log-probs, dropout off."""

    @torch.no_grad()
    def eval_step(batch: Batch) -> torch.Tensor:
        was_training = model.training
        model.eval()
        try:
            out = model(batch)
        finally:
            model.train(was_training)
        return nll_loss(out, batch["shifted_right_caption_tokens"], model.vocab.padding_idx)

    return eval_step


def scst_log_probs(model, batch: Batch, sampled: torch.Tensor) -> torch.Tensor:
    """Teacher-forced log-probs (f32) of sampled captions, zeroed strictly
    after the first <eos> (the eos step keeps its own), as
    ``openviic_tpu/training/steps.py::scst_log_probs``.

    ``sampled``: (bs * beam, L) words the beam search emitted, step t's word
    in column t; ``batch`` holds the features already expanded to bs * beam
    rows.  The decoder's input at position t is the word emitted at t - 1
    (<bos> at t = 0), the order the decode fed them.  The pick is fused:
    ``logits[word] - lse(logits)``, without a log-softmax tensor, with the
    max shift detached and both terms upcast to f32 (f64 logits stay f64)
    before the subtraction (as ``fused_nll``).  The model runs in its
    current mode."""
    vocab = model.vocab
    sampled = sampled.long()
    bos = torch.full((sampled.shape[0], 1), vocab.bos_idx, dtype=torch.long,
                     device=sampled.device)
    inputs = torch.cat([bos, sampled[:, :-1]], dim=1)
    logits = model(dict(batch, caption_tokens=inputs), raw_logits=True)
    acc = torch.promote_types(logits.dtype, torch.float32)
    m = logits.detach().amax(dim=-1, keepdim=True).to(acc)
    lse = m[..., 0] + torch.log(torch.exp(logits.to(acc) - m).sum(dim=-1))
    picked = torch.gather(logits, 2, sampled[..., None])[..., 0].to(acc) - lse
    is_eos = (sampled == vocab.eos_idx).int()
    alive = (torch.cumsum(is_eos, dim=1) - is_eos) == 0
    return picked * alive


def scst_loss(model, batch: Batch, sampled: torch.Tensor, reward: torch.Tensor,
              beam_size: int) -> torch.Tensor:
    """The SCST loss of ``make_scst_grad_step``: ``batch`` (bs, ...) repeated
    ``beam_size`` times along dim 0, then ``-(mean over L of the log-probs)
    * (reward - mean over beams of reward)``, averaged over the bs * beam
    rows."""
    bs = reward.shape[0]
    rows = {k: v.repeat_interleave(beam_size, dim=0) for k, v in batch.items()}
    lp = scst_log_probs(model, rows, sampled).reshape(bs, beam_size, -1)
    baseline = reward.mean(dim=-1, keepdim=True)
    return (-lp.mean(dim=-1) * (reward - baseline)).mean()


def make_scst_grad_step(model, beam_size: int):
    """(state, batch, sampled, reward) -> (state, loss): one SCST update of
    ``model`` (``openviic_tpu/training/steps.py::make_scst_grad_step``),
    with the optimizer in the state (``make_rl_optimizer``).

    ``batch`` is the unexpanded (bs, ...) feature batch: it is repeated
    ``beam_size`` times along dim 0 inside the step, so the encoder runs on
    bs * beam rows and, with dropout on, each row draws its own masks.
    ``sampled`` (bs * beam, L) and ``reward`` (bs, beam).  The loss is
    ``scst_loss``: the mean runs over the full length, zeroed tail
    included, as the reference's.  The step runs in f32 with dropout on,
    from the state's generator."""

    def update(state: dict, batch: Batch, sampled: torch.Tensor, reward: torch.Tensor):
        def backward():
            loss = scst_loss(model, batch, sampled, reward, beam_size)
            loss.backward()
            return loss

        return _train_update(model, state, backward)

    return update
