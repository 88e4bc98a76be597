"""A multi-process dry run of data-parallel XE training (the port's
counterpart of ``scripts/multiprocess_dryrun.py``):

    python -m openviic_tpu_torch.parallel.dryrun [--nprocs 2] [--device cuda]
        [--backend nccl|gloo] [--d-model 64 --heads 4 --layers 2 --d-ff 128 ...]

It spawns ``--nprocs`` ranks (``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT`` set as ``torchrun`` sets them).  With
the default ``--device cuda`` each rank takes the card
``cuda:<LOCAL_RANK>``, as ``train.py`` maps them, and the group runs over
NCCL; without a card it raises.  ``--device cpu`` puts every rank on the
CPU over gloo, and a card named with its index (``cuda:0``) puts every
rank on that card, which only gloo allows (NCCL refuses two ranks on one
card).  It feeds each rank its contiguous slice of a deterministic global
batch per step, trains the flagship architecture at the given widths
(random weights from a seed, dropout 0, Adam with the Noam schedule,
``parallel.mesh.make_sharded_xe_step``) and asserts:

 1. the loss is the same on every rank, and equal to one process on the
    same global batches (within ``LOSS_RTOL``, or bit for bit with
    ``--exact``);
 2. the parameters are bit-equal across ranks;
 3. after rank 0 saves a checkpoint at ``--save-at`` behind a barrier,
    every rank restores it into a fresh model and the resumed losses are
    bit-identical to the uninterrupted run's; the same checkpoint resumed
    by one process matches the run within ``LOSS_RTOL`` (losses) and, under
    ``--optimizer sgd`` (an update is then lr times the gradient), 2e-4 /
    1e-5 (parameters): Adam's first steps move a parameter whose gradient
    is rounding noise, a key projection's bias, by the whole learning rate
    either way, so under Adam that check holds the losses only.

With ``--nprocs 1 --in-process`` the one rank runs in this process over
``--backend`` (a group on a file store in the run's directory).  It prints one
JSON summary (each run's ms a step, the all-reduce's ms and MiB a step)
and ``dryrun ok``; any failure raises.  ``run(options)`` does the same from
Python, ``parse(argv)`` gives the options."""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

import numpy as np
import torch

LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 2e-4, 1e-5  # tests/test_tensor_parallel.py's bar (under SGD)
SGD_LR = 0.05  # that test's
SPECIALS = ["<pad>", "<bos>", "<eos>", "<unk>"]


def parse(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="data-parallel dry run across processes")
    p.add_argument("--nprocs", type=int, default=2)
    p.add_argument("--device", default="cuda",
                   help="cuda: each rank on cuda:<LOCAL_RANK>; cpu or cuda:<i>: every rank there")
    p.add_argument("--backend", default=None, choices=("gloo", "nccl"),
                   help="default: nccl on a card, gloo on the CPU")
    p.add_argument("--in-process", action="store_true",
                   help="with --nprocs 1: run the one rank in this process")
    p.add_argument("--d-model", type=int, default=64)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--d-ff", type=int, default=128)
    p.add_argument("--d-feature", type=int, default=32)
    p.add_argument("--regions", type=int, default=8)
    p.add_argument("--vocab", type=int, default=64)
    p.add_argument("--max-len", type=int, default=10)
    p.add_argument("--global-batch", type=int, default=16)
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--save-at", type=int, default=3)
    p.add_argument("--warmup", type=int, default=100)
    p.add_argument("--optimizer", default="adam", choices=("adam", "sgd"),
                   help="Adam with the Noam schedule, or SGD at lr 0.05")
    p.add_argument("--exact", action="store_true",
                   help="hold the ranks' losses to the single process's bit for bit")
    p.add_argument("--threads", type=int, default=0, help="torch threads a process (0: torch's)")
    p.add_argument("--timeout", type=float, default=600.0, help="seconds for the ranks")
    p.add_argument("--out", default=None, help="the run's directory (default: a temporary one)")
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    opts = p.parse_args(argv)
    if opts.global_batch % opts.nprocs:
        p.error(f"--global-batch {opts.global_batch} must divide by --nprocs {opts.nprocs}")
    if not 0 < opts.save_at < opts.steps:
        p.error("--save-at must lie between 0 and --steps")
    return opts


def _config(opts):
    from openviic_tpu_torch.artifact import artifact_config

    model = artifact_config(name="dryrun", d_model=opts.d_model, heads=opts.heads,
                            layers=opts.layers, d_ff=opts.d_ff).MODEL.to_dict()
    model["VISION_EMBEDDING"]["D_FEATURE"] = opts.d_feature

    def walk(node):
        if isinstance(node, dict):
            return {k: (0.0 if k == "DROPOUT" else walk(v)) for k, v in node.items()}
        return node

    from openviic_tpu_torch.config import ConfigNode

    return ConfigNode(walk(model))


def rank_device(opts) -> torch.device:
    """This process's device: ``cuda:<LOCAL_RANK>`` for ``--device cuda``,
    else ``--device`` itself.  A card asked for and absent raises."""
    device = torch.device(opts.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"dryrun: --device {opts.device} and no CUDA device is "
                               "available; pass --device cpu to run on gloo on the CPU")
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return device


def _vocab(opts):
    from openviic_tpu_torch.data.vocab import Vocab

    return Vocab(SPECIALS + [f"w{i}" for i in range(opts.vocab - len(SPECIALS))], opts.max_len)


def global_batch(opts, vocab, step: int) -> Dict[str, torch.Tensor]:
    """The global batch of ``step``, the same in every process: f32
    regions with a ragged count of zero rows, captions of ragged length
    (so the ranks' token counts differ)."""
    rng = np.random.default_rng(1000 + step)
    gb, n, L = opts.global_batch, opts.regions, vocab.max_caption_length
    feats = rng.normal(size=(gb, n, opts.d_feature)).astype(np.float32)
    tokens = np.full((gb, L), vocab.padding_idx, np.int64)
    target = np.full((gb, L), vocab.padding_idx, np.int64)
    for i in range(gb):
        feats[i, n - i % 3:] = 0.0
        words = rng.integers(len(SPECIALS), len(vocab), size=1 + (i * 5 + step) % (L - 2))
        enc = np.concatenate([[vocab.bos_idx], words, [vocab.eos_idx]])
        tokens[i, :len(enc) - 1] = enc[:-1]
        target[i, :len(enc) - 1] = enc[1:]
    return {"region_features": torch.from_numpy(feats), "caption_tokens": torch.from_numpy(tokens),
            "shifted_right_caption_tokens": torch.from_numpy(target)}


def _build(opts, vocab, device, seed: int):
    from openviic_tpu_torch.builders import build_model
    from openviic_tpu_torch.training.optim import make_optimizer
    from openviic_tpu_torch.training.steps import init_xe_state

    model = build_model(_config(opts), vocab, device=device, seed=seed)
    if opts.optimizer == "sgd":
        optimizer, scheduler = torch.optim.SGD(model.parameters(), lr=SGD_LR), None
    else:
        optimizer, scheduler = make_optimizer(model.parameters(), opts.d_model, opts.warmup)
    return model, init_xe_state(model, optimizer, scheduler, seed=42)


def _restore(model, state, loaded) -> None:
    model.load_state_dict(loaded["model"])
    state["optimizer"].load_state_dict(loaded["optimizer"])
    if state["scheduler"] is not None:
        state["scheduler"].load_state_dict(loaded["scheduler"])
    state["step"] = int(loaded["step"])
    state["generator"].set_state(loaded["generator"])


def _digest(model) -> str:
    h = hashlib.sha256()
    for name, p in model.named_parameters():
        h.update(name.encode())
        h.update(p.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextmanager
def _timed_allreduce(device, spent: List[float]):
    """Each gradient all-reduce's seconds (the device synchronized before
    and after) into ``spent``."""
    from openviic_tpu_torch.parallel import mesh as dp

    real = dp.allreduce_gradients

    def timed(*args, **kwargs):
        _sync(device)
        t0 = time.perf_counter()
        out = real(*args, **kwargs)
        _sync(device)
        spent.append(time.perf_counter() - t0)
        return out

    dp.allreduce_gradients = timed
    try:
        yield
    finally:
        dp.allreduce_gradients = real


def _steps(opts, vocab, model, state, mesh, first: int, on_save=None):
    """Steps ``first`` .. ``opts.steps - 1`` on this rank's rows: (losses,
    ms a step, all-reduce ms a step)."""
    from openviic_tpu_torch.parallel import mesh as dp

    device = next(model.parameters()).device
    step = dp.make_sharded_xe_step(model, mesh)
    losses, ms, ar_ms = [], [], []
    for s in range(first, opts.steps):
        batch = {k: v.to(device) for k, v in dp.batch_shard(global_batch(opts, vocab, s),
                                                            mesh).items()}
        spent: List[float] = []
        _sync(device)
        t0 = time.perf_counter()
        with _timed_allreduce(device, spent):
            state, loss = step(state, batch)
        losses.append(float(loss))  # waits for the step
        ms.append(1e3 * (time.perf_counter() - t0))
        ar_ms.append(1e3 * sum(spent))
        if on_save is not None and s + 1 == opts.save_at:
            on_save(state)
    return losses, ms, ar_ms


def train_rank(opts, out_dir: str) -> dict:
    """One rank's run (one process without a group): the uninterrupted
    steps with rank 0's checkpoint at ``save_at``, then the resume of every
    rank from it.  Rank 0 also keeps its final parameters in ``out_dir``."""
    from openviic_tpu_torch.parallel import mesh as dp
    from openviic_tpu_torch.parallel import runtime
    from openviic_tpu_torch.training import checkpoint as ckpt

    device = rank_device(opts)
    vocab = _vocab(opts)
    mesh = dp.make_mesh()
    model, state = _build(opts, vocab, device, seed=0)
    dp.shard_state(model, state, mesh)
    path = os.path.join(out_dir, "dryrun.ckpt")

    def save(st):
        if mesh.rank == 0:
            ckpt.save_checkpoint(path, model, st, {"step_saved": opts.save_at})
        runtime.barrier("dryrun_ckpt")

    before = mesh.allreduced_bytes
    losses, ms, ar_ms = _steps(opts, vocab, model, state, mesh, 0, on_save=save)
    mib = (mesh.allreduced_bytes - before) / 2**20 / opts.steps
    digest = _digest(model)
    if mesh.rank == 0 and mesh.collective:
        torch.save({n: p.detach().cpu() for n, p in model.named_parameters()},
                   os.path.join(out_dir, "final_params.pt"))
    del model, state
    model, state = _build(opts, vocab, device, seed=1)  # other weights until the restore
    _restore(model, state, ckpt.load_checkpoint(path))
    resumed, _, _ = _steps(opts, vocab, model, state, mesh, opts.save_at)
    return {"rank": mesh.rank, "world": mesh.size, "losses": losses, "resumed": resumed,
            "digest": digest, "resumed_digest": _digest(model), "ms": ms,
            "allreduce_ms": ar_ms, "allreduce_mib_per_step": mib}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker_argv(opts, out_dir: str) -> List[str]:
    argv = []
    for key, value in vars(opts).items():
        if key in ("worker", "out", "in_process") or value is None or value is False:
            continue
        flag = "--" + key.replace("_", "-")
        argv += [flag] if value is True else [flag, str(value)]
    return argv + ["--worker", "--out", out_dir]


def start(argv: List[str], nprocs: int, out_dir: str) -> list:
    """Start ``nprocs`` ranks of ``python argv`` as ``torchrun`` starts them
    (this checkout's package importable; each rank's output in
    ``out_dir/rank<r>.log``)."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    path = os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p)
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(nprocs), PYTHONPATH=path)
    procs = []
    for rank in range(nprocs):
        with open(os.path.join(out_dir, f"rank{rank}.log"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, *argv], env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank)),
                stdout=log, stderr=subprocess.STDOUT))
    return procs


def wait(procs: list, out_dir: str, timeout: float) -> None:
    """Wait for ``start``'s ranks; all are killed when one fails or
    ``timeout`` seconds pass, and then it raises with each rank's log."""
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if (time.monotonic() > deadline
                    or any(p.poll() not in (None, 0) for p in procs)):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if any(p.returncode != 0 for p in procs):
        logs = []
        for rank in range(len(procs)):
            with open(os.path.join(out_dir, f"rank{rank}.log")) as f:
                logs.append(f"rank {rank}: " + f.read()[-3000:])
        raise AssertionError(f"ranks exited {[p.returncode for p in procs]} (a rank past "
                             f"{timeout:g} s is killed): " + " | ".join(logs))


def _in_process(opts, out_dir: str) -> dict:
    from openviic_tpu_torch.parallel import runtime

    # a file store: no port to pick, no server to start
    runtime.initialize_distributed(rank_device(opts), backend=opts.backend,
                                   init_method="file://" + os.path.join(out_dir, "group"),
                                   world_size=1, rank=0)
    try:
        return train_rank(opts, out_dir)
    finally:
        runtime.shutdown()


def _median(xs) -> float:
    return float(np.median(xs)) if len(xs) else float("nan")


def run(opts) -> dict:
    """The dry run (see the module's docstring); returns its summary."""
    out_dir = opts.out or tempfile.mkdtemp(prefix="openviic_dryrun_")
    os.makedirs(out_dir, exist_ok=True)
    threads = torch.get_num_threads()
    try:
        if opts.threads:
            torch.set_num_threads(opts.threads)
        cards = torch.cuda.device_count() if rank_device(opts).type == "cuda" else 0
        if opts.device == "cuda" and not opts.in_process and opts.nprocs > cards:
            raise ValueError(f"--nprocs {opts.nprocs} takes one card a rank and {cards} are "
                             "visible; --device cuda:0 --backend gloo puts every rank on one")
        # one process first, alone on the device, so that its times are its own
        single = train_rank(opts, tempfile.mkdtemp(dir=out_dir))
        if opts.nprocs == 1 and opts.in_process:
            ranks = [_in_process(opts, out_dir)]
        else:
            procs = start(["-m", "openviic_tpu_torch.parallel.dryrun",
                           *_worker_argv(opts, out_dir)], opts.nprocs, out_dir)
            wait(procs, out_dir, opts.timeout)
            ranks = []
            for rank in range(opts.nprocs):
                with open(os.path.join(out_dir, f"rank{rank}.json")) as f:
                    ranks.append(json.load(f))
        failures = []
        for r in ranks:
            if r["losses"] != ranks[0]["losses"]:
                failures.append(f"rank {r['rank']}'s losses {r['losses']} differ from rank 0's "
                                f"{ranks[0]['losses']}")
            if r["digest"] != ranks[0]["digest"]:
                failures.append(f"rank {r['rank']}'s parameters differ from rank 0's")
            if r["resumed"] != r["losses"][opts.save_at:]:
                failures.append(f"rank {r['rank']}'s resumed losses {r['resumed']} differ from "
                                f"its run's {r['losses'][opts.save_at:]}")
            if r["resumed_digest"] != r["digest"]:
                failures.append(f"rank {r['rank']}'s resumed parameters differ from its run's")
        got, want = np.asarray(ranks[0]["losses"]), np.asarray(single["losses"])
        gap = float(np.max(np.abs(got - want) / np.abs(want)))
        if (opts.exact and got.tolist() != want.tolist()) or gap > LOSS_RTOL:
            failures.append(f"the ranks' losses {got.tolist()} against one process's "
                            f"{want.tolist()}: relative gap {gap:.3g}")
        if opts.exact and ranks[0]["digest"] != single["digest"]:
            failures.append("the ranks' parameters differ from one process's")
        backend = opts.backend or ("nccl" if rank_device(opts).type == "cuda" else "gloo")
        summary = {"nprocs": opts.nprocs, "backend": backend, "device": opts.device,
                   "losses": ranks[0]["losses"], "single_losses": single["losses"],
                   "loss_rel_gap": gap,
                   "single_ms": _median(single["ms"][1:]),
                   "ranks_ms": [_median(r["ms"][1:]) for r in ranks],
                   "allreduce_ms": [_median(r["allreduce_ms"][1:]) for r in ranks],
                   "allreduce_mib_per_step": ranks[0]["allreduce_mib_per_step"]}
        if opts.nprocs > 1:  # the world's checkpoint resumed by one process
            from openviic_tpu_torch.parallel import mesh as dp
            from openviic_tpu_torch.training import checkpoint as ckpt

            vocab = _vocab(opts)
            model, state = _build(opts, vocab, rank_device(opts), seed=1)
            _restore(model, state, ckpt.load_checkpoint(os.path.join(out_dir, "dryrun.ckpt")))
            resumed, _, _ = _steps(opts, vocab, model, state, dp.make_mesh(), opts.save_at)
            want_tail = np.asarray(ranks[0]["losses"][opts.save_at:])
            tail_gap = float(np.max(np.abs(np.asarray(resumed) - want_tail) / np.abs(want_tail)))
            final = torch.load(os.path.join(out_dir, "final_params.pt"), weights_only=True)
            close = all(torch.allclose(p.detach().cpu(), final[n], rtol=PARAM_RTOL,
                                       atol=PARAM_ATOL) for n, p in model.named_parameters())
            summary.update(world1_resume_rel_gap=tail_gap, world1_resume_params_close=close)
            if tail_gap > LOSS_RTOL or (opts.optimizer == "sgd" and not close):
                failures.append(f"the world-{opts.nprocs} checkpoint resumed by one process: "
                                f"loss gap {tail_gap:.3g}, parameters within the bar {close}")
        if failures:
            raise AssertionError("; ".join(failures))
        return summary
    finally:
        torch.set_num_threads(threads)
        if opts.out is None:
            shutil.rmtree(out_dir, ignore_errors=True)


def main(argv: Optional[List[str]] = None) -> int:
    opts = parse(argv)
    if opts.worker:
        from openviic_tpu_torch.parallel import runtime

        if opts.threads:
            torch.set_num_threads(opts.threads)
        runtime.initialize_distributed(rank_device(opts), backend=opts.backend)
        try:
            result = train_rank(opts, opts.out)
        finally:
            runtime.shutdown()
        with open(os.path.join(opts.out, f"rank{result['rank']}.json"), "w") as f:
            json.dump(result, f)
        return 0
    print(json.dumps(run(opts)), flush=True)
    print("dryrun ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
