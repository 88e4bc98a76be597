"""Optimizer and learning-rate schedule (the port's counterpart of
``openviic_tpu/training/optim.py``, in PyTorch's idiom).

Adam (betas 0.9/0.98, eps 1e-8, optax's defaults) with the Noam schedule
``lr = base_lr * d_model^-0.5 * min(step^-0.5, step * warmup^-1.5)``, step
starting at 1, as a ``LambdaLR`` stepped once per update: its count 0 is
the first update, as optax's is."""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional

import torch

ADAM_EPS = 1e-8  # optax.adam's default, also torch's


def noam_schedule(d_model: int, warmup: int, base_lr: float = 1.0) -> Callable[[int], float]:
    """count -> learning rate; count 0 is the first update."""

    def schedule(count: int) -> float:
        step = count + 1.0
        return base_lr * (d_model ** -0.5) * min(step ** -0.5, step * warmup ** -1.5)

    return schedule


def make_optimizer(params: Iterable[torch.nn.Parameter], d_model: int, warmup: int,
                   base_lr: float = 1.0):
    """(Adam, its Noam ``LambdaLR``) for the XE phase; call
    ``scheduler.step()`` after every ``optimizer.step()``."""
    optimizer = torch.optim.Adam(params, lr=1.0, betas=(0.9, 0.98), eps=ADAM_EPS)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, noam_schedule(d_model, warmup, base_lr))
    return optimizer, scheduler


def fast_forward_schedule(optimizer: torch.optim.Optimizer, scheduler, step: int) -> None:
    """Fresh Adam moments, with the schedule resumed at ``step`` (not its
    warmup's start): for continuing from weights that carry no optimizer
    state.  The next update runs at ``schedule(step)`` with Adam's bias
    correction of a first update."""
    optimizer.state.clear()
    scheduler.last_epoch = int(step)
    for group, base, fn in zip(optimizer.param_groups, scheduler.base_lrs,
                               scheduler.lr_lambdas):
        group["lr"] = base * fn(int(step))
    scheduler._last_lr = [group["lr"] for group in optimizer.param_groups]


def optimizer_state_fits(optimizer: torch.optim.Optimizer, saved: dict) -> bool:
    """Whether the optimizer ``state_dict`` ``saved`` fits ``optimizer``: as
    many groups and parameters, the same hyperparameters but the learning
    rate (the XE and RL Adams differ in their betas), and every moment of
    its parameter's shape."""
    groups, saved_groups = optimizer.param_groups, saved.get("param_groups", [])
    if len(groups) != len(saved_groups):
        return False
    index = {}
    for group, saved_group in zip(groups, saved_groups):
        if len(group["params"]) != len(saved_group["params"]):
            return False
        for key in ("betas", "eps", "weight_decay", "amsgrad", "maximize"):
            if key in group and _hyper(group[key]) != _hyper(saved_group.get(key)):
                return False
        index.update(zip(saved_group["params"], group["params"]))
    for i, entry in saved.get("state", {}).items():
        if i not in index:
            return False
        for key in ("exp_avg", "exp_avg_sq"):
            if key in entry and tuple(entry[key].shape) != tuple(index[i].shape):
                return False
    return True


def _hyper(value):
    return tuple(float(v) for v in value) if isinstance(value, (tuple, list)) else value


def make_rl_optimizer(params: Iterable[torch.nn.Parameter], rl_learning_rate: float):
    """Fresh Adam at a fixed learning rate for the SCST phase."""
    return torch.optim.Adam(params, lr=rl_learning_rate, betas=(0.9, 0.999), eps=ADAM_EPS)


def frozen_param_mask(model: torch.nn.Module) -> Optional[Dict[str, bool]]:
    """{parameter name: trainable}: False under a module named ``backbone``
    (or starting so), the pretrained language-model backbone that the JAX
    package keeps out of its optimizer.  None when nothing is frozen."""
    names = [name for name, _ in model.named_parameters()]
    frozen = [any(part.startswith("backbone") for part in name.split(".")) for name in names]
    if not any(frozen):
        return None
    return {name: not f for name, f in zip(names, frozen)}


def mask_frozen(model: torch.nn.Module) -> List[torch.nn.Parameter]:
    """The parameters to hand the optimizer: all of them, unless
    ``frozen_param_mask`` finds a backbone, whose parameters get no Adam
    moments."""
    mask = frozen_param_mask(model)
    return [p for name, p in model.named_parameters() if mask is None or mask[name]]
