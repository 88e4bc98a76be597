"""Rank functions that ``openviic_tpu_torch.parallel.launch.spawn`` runs for
``tests/test_torch_port_orbax_checkpoint.py`` and
``tests/test_torch_port_local_data_parallel.py``: each rank is a new
process of a gloo group on the CPU, and writes its results to
``<out>/rank<r>.json`` (and ``.npz``).  This module imports no JAX, so a
rank starts in the time torch takes to import."""

import json
import os

import numpy as np
import torch


def orbax_rank(device, out: str) -> None:
    """A collective save, copy and load through the DCP backend on every
    rank, and a finished staging directory adopted: the ranks' barrier
    names in order, the renames each made, the files each found, and
    whether what it loaded equals what was saved."""
    from openviic_tpu_torch.parallel import runtime
    from openviic_tpu_torch.training import orbax_backend

    rank = runtime.process_index()
    renames = []
    real_rename = os.rename

    def counted_rename(src, dst):
        renames.append([os.path.basename(src), os.path.basename(dst)])
        return real_rename(src, dst)

    barriers = []
    real_gather = runtime.all_gather_object

    def gather(obj):
        out_ = real_gather(obj)
        barriers.append(out_)
        return out_

    os.rename, runtime.all_gather_object = counted_rename, gather
    try:
        torch.manual_seed(0)  # the same weights on every rank
        model = torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.Linear(5, 3))
        opt = torch.optim.Adam(model.parameters(), lr=1e-2, betas=(0.9, 0.98))
        model(torch.randn(4, 6)).square().sum().backward()
        opt.step()
        state = {"optimizer": opt, "scheduler": None, "step": 7,
                 "generator": torch.Generator().manual_seed(11)}
        last, best = os.path.join(out, "last_model.orbax"), os.path.join(out, "best_model.orbax")
        be = orbax_backend.OrbaxBackend()
        be.save_checkpoint(last, model, state, {"epoch": 3, "rank_written": rank})
        be.copy(last, best)  # waits: the write, then the swap
        files = sorted(os.listdir(best))
        loaded = be.load_checkpoint(best)
        equal = all(torch.equal(loaded["model"][k], v) for k, v in model.state_dict().items())
        equal = equal and loaded["step"] == 7 and loaded["optimizer"]["state"][0]["exp_avg"].equal(
            opt.state_dict()["state"][0]["exp_avg"])
        # a finished staging directory whose swap never ran: adopted by all
        be.save_checkpoint(os.path.join(out, "crash.orbax"), model, state, {"epoch": 4})
        be._future.result()
        be._future = be._pending_swap = None
        runtime.barrier("staging_written")
        adopted = be.load_checkpoint(os.path.join(out, "crash.orbax"))
        result = {"rank": rank, "renames": renames, "barriers": barriers, "files": files,
                  "equal": bool(equal), "epoch": loaded["epoch"],
                  "adopted_epoch": adopted["epoch"]}
    finally:
        os.rename, runtime.all_gather_object = real_rename, real_gather
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)


def grad_peaks(model) -> dict:
    """Each parameter's largest |gradient| of the step just taken (the
    gradients summed over the ranks)."""
    return {k: float(p.grad.abs().max()) for k, p in model.named_parameters()
            if p.grad is not None}


def epochs_rank(device, out: str, config, params_file: str) -> None:
    """One XE epoch, then one SCST epoch, of the port's trainer in a
    host-local group: the trainer built from ``config`` with the JAX
    initial weights of ``params_file``; after each epoch its mean loss,
    the step count, every parameter (``rank<r>_<phase>.npz``) and the
    gradients' peaks of its last step; the references of each SCST
    iteration's images on this rank, and the mean |term| of its SCST loss
    (``-mean log-prob * (reward - baseline)`` of each of its rows, the
    scale of the loss's rounding); the mesh and the loaders it took."""
    from openviic_tpu_torch.builders import build_trainer
    from openviic_tpu_torch.compat.from_jax import load_jax_params
    from openviic_tpu_torch.parallel import mesh as mesh_module
    from openviic_tpu_torch.parallel import runtime
    from openviic_tpu_torch.training import steps
    from openviic_tpu_torch.training import trainer as trainer_module

    torch.set_num_threads(1)
    rank = runtime.process_index()
    tr = build_trainer(config, device=device)
    with np.load(params_file) as z:
        load_jax_params(tr.model, dict(z))
    result = {"rank": rank, "mesh": tr.mesh.size, "host_local": runtime.host_local(),
              "loader": type(tr.train_dataloader).__name__,
              "batch": tr.train_dataloader.batch_size,
              "parts": [tr.train_dataloader.part, tr.train_dict_dataloader.part],
              "dict_drop_last": tr.train_dict_dataloader.drop_last, "scst_refs": [],
              "scst_term_scales": []}
    real, real_loss = trainer_module.scst_iteration, mesh_module.scst_loss

    def recorded(setup, batch, captions, marks=None):
        result["scst_refs"].append([list(c) for c in captions])
        return real(setup, batch, captions, marks)

    def scaled_loss(model, batch, sampled, reward, beam_size):
        rows = {k: v.repeat_interleave(beam_size, dim=0) for k, v in batch.items()}
        with torch.no_grad():
            lp = steps.scst_log_probs(model, rows, sampled).reshape(*reward.shape, -1)
        terms = lp.mean(dim=-1) * (reward - reward.mean(dim=-1, keepdim=True))
        result["scst_term_scales"].append(float(terms.abs().mean()))
        return real_loss(model, batch, sampled, reward, beam_size)

    trainer_module.scst_iteration, mesh_module.scst_loss = recorded, scaled_loss
    for phase, epoch in (("xe", tr.train), ("scst", tr.train_scst)):
        result[phase] = {"loss": epoch(), "step": int(tr.state["step"]),
                         "grad_peaks": grad_peaks(tr.model)}
        np.savez(os.path.join(out, f"rank{rank}_{phase}.npz"),
                 **{k: v.detach().numpy() for k, v in tr.model.state_dict().items()})
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
