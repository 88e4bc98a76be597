"""One rank of the port's data-parallel checks in
``tests/test_torch_port_distributed.py``, run as a process of its own:

    RANK=r WORLD_SIZE=2 MASTER_ADDR=localhost MASTER_PORT=p \\
        python tests/torch_port_dp_worker.py <steps|trainer> <directory>

It imports torch and the port only (no JAX), starts the gloo group from
those variables through ``parallel.runtime.initialize_distributed``, reads
its inputs from ``<directory>`` (written by the test) and writes its
results there as ``<job>_rank<r>.pt``.

``steps``: three data-parallel XE steps under SGD from the JAX weights on
this rank's rows of the test's global batches; the trainer's XE step with
``LABEL_SMOOTHING``, ``MIXED_PRECISION`` and ``STEPS_PER_CALL`` set against
it without them; one data-parallel SCST step on this rank's rows.

``trainer``: ``BaseTrainer`` on the test's config (grain loader, pinned
regions, PATIENCE 0), run U for three epochs and its predictions, then run
R for one epoch and a new trainer for two; the files each rank wrote, each
epoch's decisions, the final parameters' digest and the metrics rows."""

from __future__ import annotations

import builtins
import hashlib
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from openviic_tpu_torch.builders import build_model, build_trainer  # noqa: E402
from openviic_tpu_torch.compat.from_jax import load_jax_params  # noqa: E402
from openviic_tpu_torch.config import ConfigNode  # noqa: E402
from openviic_tpu_torch.data.vocab import Vocab  # noqa: E402
from openviic_tpu_torch.parallel import mesh as dp  # noqa: E402
from openviic_tpu_torch.parallel import runtime  # noqa: E402
from openviic_tpu_torch.training import checkpoint as ckpt  # noqa: E402
from openviic_tpu_torch.training import trainer as trainer_module  # noqa: E402
from openviic_tpu_torch.training.steps import init_xe_state  # noqa: E402

SGD_LR = 0.05
SPECIALS = ["<pad>", "<bos>", "<eos>", "<unk>"]


def _model(job, flat):
    vocab = Vocab(SPECIALS + [f"w{i}" for i in range(job["vocab"] - len(SPECIALS))],
                  job["max_len"])
    model = build_model(ConfigNode(job["model"]), vocab, device="cpu")
    load_jax_params(model, flat)
    state = init_xe_state(model, torch.optim.SGD(model.parameters(), lr=SGD_LR), seed=0)
    return model, state


def _params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def steps_job(directory: str, mesh) -> dict:
    with open(os.path.join(directory, "job.json")) as f:
        job = json.load(f)
    with np.load(os.path.join(directory, "params.npz")) as z:
        flat = dict(z)
    with np.load(os.path.join(directory, "batches.npz")) as z:
        arrays = dict(z)
    out = {"backend": torch.distributed.get_backend(), "rank": runtime.process_index(),
           "world": runtime.process_count()}

    def rows(prefix):
        """This rank's rows of the global arrays named ``<prefix><key>``."""
        return dp.batch_shard({k[len(prefix):]: torch.from_numpy(v) for k, v in arrays.items()
                               if k.startswith(prefix)}, mesh)

    model, state = _model(job, flat)
    dp.shard_state(model, state, mesh)
    step = dp.make_sharded_xe_step(model, mesh)
    out["xe_losses"] = []
    for i in range(job["xe_steps"]):
        state, loss = step(state, rows(f"xe{i}_"))
        out["xe_losses"].append(float(loss))
    out["xe_params"] = _params(model)

    # the trainer's XE step under data parallel, with and without the keys
    # that the single-process step honours
    tuned = ConfigNode({"LABEL_SMOOTHING": 0.1, "MIXED_PRECISION": True, "STEPS_PER_CALL": 2})
    quirk = {}
    for name, training in (("plain", ConfigNode({})), ("tuned", tuned)):
        model, state = _model(job, flat)
        xe, multi = trainer_module.make_xe_steps(model, training, 1, mesh)
        state, loss = xe(state, rows("xe0_"))
        quirk[name] = (float(loss), _params(model), multi is None)
    out["quirk"] = quirk

    model, state = _model(job, flat)
    step = dp.make_sharded_scst_step(model, job["beam"], mesh)
    scst = rows("scst_")
    batch = {"region_features": scst["region_features"]}
    state, loss = step(state, batch, scst["sampled"], scst["reward"])
    out["scst_loss"] = float(loss)
    out["scst_params"] = _params(model)
    return out


class _Writes:
    """Counts of the files opened for writing through the trainer module's
    ``open`` and of the checkpoint backend's saves and copies."""

    def __init__(self):
        self.files, self.saves, self.copies = {}, 0, 0

    def open(self, path, mode="r", *args, **kwargs):
        if any(c in mode for c in "wax+"):
            name = os.path.basename(path)
            self.files[name] = self.files.get(name, 0) + 1
        return builtins.open(path, mode, *args, **kwargs)


def trainer_job(directory: str, mesh) -> dict:
    with open(os.path.join(directory, "trainer.json")) as f:
        config = json.load(f)
    writes = _Writes()
    trainer_module.open = writes.open
    save, copy = ckpt.NativeBackend.save_checkpoint, ckpt.NativeBackend.copy

    def counted_save(backend, *args, **kwargs):
        writes.saves += 1
        return save(backend, *args, **kwargs)

    def counted_copy(backend, *args, **kwargs):
        writes.copies += 1
        return copy(backend, *args, **kwargs)

    ckpt.NativeBackend.save_checkpoint, ckpt.NativeBackend.copy = counted_save, counted_copy
    out = {"rank": runtime.process_index()}

    def make(run: str):
        cfg = json.loads(json.dumps(config))
        cfg["TRAINING"]["CHECKPOINT_PATH"] = os.path.join(directory, run)
        tr = build_trainer(ConfigNode(cfg), device="cpu")
        decisions, phases, agreed = [], [], []
        real_save, real_train, real_scst = tr.save_checkpoint, tr.train, tr.train_scst

        def save_checkpoint(extras):
            decisions.append({"epoch": tr.epoch, **extras})
            agreed.append(tr.scores_agreed)
            return real_save(extras)

        def train():
            phases.append("xe")
            return real_train()

        def train_scst():
            phases.append("scst")
            return real_scst()

        tr.save_checkpoint, tr.train, tr.train_scst = save_checkpoint, train, train_scst
        return tr, {"decisions": decisions, "phases": phases, "agreed": agreed}

    def digest(tr):
        h = hashlib.sha256()
        for n, p in tr.model.named_parameters():
            h.update(p.detach().contiguous().numpy().tobytes())
        return h.hexdigest()

    def rows(tr):
        path = os.path.join(tr.checkpoint_path, "metrics.jsonl")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return [{k: v for k, v in json.loads(line).items()
                     if k not in ("time", "train/captions_per_sec")} for line in f]

    u, u_rec = make("U")
    out["loaders"] = {"train": (u.train_dataloader.shard_index, u.train_dataloader.shard_count,
                                type(u.train_dataloader).__name__, u.train_dataloader.drop_last),
                      "train_dict": (u.train_dict_dataloader.shard_index,
                                     u.train_dict_dataloader.shard_count,
                                     u.train_dict_dataloader.drop_last),
                      "val_dict": (u.val_dict_dataloader.shard_index,
                                   u.val_dict_dataloader.shard_count)}
    out["multi_step"] = u.xe_multi_step is not None
    out["metrics_file"] = u.metrics._file.name
    u.start(max_epochs=3)
    u.get_predictions()
    runtime.barrier("predictions")  # rank 0 writes test_results.json as it ends
    out["U"] = dict(u_rec, digest=digest(u), rows=rows(u))
    out["U_writes"] = {"files": dict(writes.files), "saves": writes.saves,
                       "copies": writes.copies}
    out["U_test_results"] = os.path.isfile(os.path.join(u.checkpoint_path,
                                                        "test_results.json"))
    del u
    r, r_rec = make("R")
    r.start(max_epochs=1)
    del r
    r, r_rec2 = make("R")
    r.start(max_epochs=2)
    out["R"] = {"decisions": r_rec["decisions"] + r_rec2["decisions"],
                "phases": r_rec["phases"] + r_rec2["phases"], "digest": digest(r),
                "rows": rows(r)}
    return out


def main() -> int:
    job, directory = sys.argv[1], sys.argv[2]
    torch.set_num_threads(1)
    assert runtime.initialize_distributed("cpu")
    try:
        mesh = dp.make_mesh()
        result = (steps_job if job == "steps" else trainer_job)(directory, mesh)
    finally:
        runtime.shutdown()
    torch.save(result, os.path.join(directory, f"{job}_rank{result['rank']}.pt"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
