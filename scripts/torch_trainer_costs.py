#!/usr/bin/env python3
"""What the trainer phase's settings cost the XE step, on the card.

    python3 scripts/torch_trainer_costs.py [--out costs.json]   # one NVIDIA GPU

``chip_smoke.py``'s trainer phase runs in a child process of its own
(``chip_smoke.py --trainer-phase``) that sets
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` before CUDA starts and runs under
``torch.use_deterministic_algorithms(True)``; its other phases run with
neither, since the setting slows the XE step (what this script
measured).  This script times, in a
fresh process for each setting (the variable must be set before CUDA
starts), in the order A B C C B A:

 A. the variable unset, deterministic algorithms off;
 B. ``CUBLAS_WORKSPACE_CONFIG=:4096:8``, deterministic algorithms off;
 C. ``:4096:8``, deterministic algorithms on;

each child measuring, on the trained artifact's weights,

 - the XE step as ``chip_smoke.py``'s xe phase times it (batch 60 of the
   artifact's captions, bf16 mixed precision, dropout 0.1; the median of
   steps 2-20 between CUDA events);
 - the trainer's XE epoch on ``chip_smoke.py``'s trainer cell (8 steps,
   the loader included): the second of two epochs, seconds between device
   synchronizations.

Prints the card's name and power limit first, then one line a child and
each setting's values in order."""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SETTINGS = {"A": (None, False), "B": (":4096:8", False), "C": (":4096:8", True)}
ORDER = "ABCCBA"


def child(deterministic: bool) -> dict:
    import numpy as np
    import torch

    import chip_smoke
    from openviic_tpu_torch import artifact
    from openviic_tpu_torch.builders import build_trainer
    from openviic_tpu_torch.training import optim, steps

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda:0")
    torch.use_deterministic_algorithms(deterministic)
    loaded = artifact.load_trained_artifact(device="cpu")
    model_cfg, state = chip_smoke.train_config(chip_smoke.FLAGSHIP, True, loaded)

    # the xe phase's step
    model = chip_smoke.train_model(model_cfg, state, loaded["vocab"], device, 0.1)
    optimizer, scheduler = optim.make_optimizer(
        model.parameters(), model_cfg["ENCODER"]["D_MODEL"], chip_smoke.XE_WARMUP)
    xe_state = steps.init_xe_state(model, optimizer, scheduler, seed=1)
    step = steps.make_xe_step(model, mixed_precision=True)
    batch = {k: v.to(device) for k, v in chip_smoke.xe_batches(loaded["vocab"], loaded, 1,
                                                                chip_smoke.XE_BATCH)[0].items()}
    times = []
    for _ in range(chip_smoke.XE_RUN_STEPS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        xe_state, loss = step(xe_state, batch)
        end.record()
        torch.cuda.synchronize(device)
        times.append(start.elapsed_time(end))
    del model, optimizer, scheduler, xe_state

    # the trainer cell's XE epoch
    tmp = tempfile.mkdtemp(prefix="openviic_trainer_costs_")
    try:
        data = os.path.join(tmp, "data")
        chip_smoke.trainer_dataset(data, loaded, chip_smoke.TRAINER_SPLIT)
        cfg = chip_smoke.trainer_config(data, os.path.join(tmp, "run"), chip_smoke.FLAGSHIP, True)
        run_dir = os.path.join(cfg.TRAINING.CHECKPOINT_PATH, chip_smoke.TRAINER_NAME)
        os.makedirs(run_dir)
        shutil.copyfile(artifact.ARTIFACT_DIR / "vocab.bin", os.path.join(run_dir, "vocab.bin"))
        tr = build_trainer(cfg, device=device)
        tr.model.load_state_dict(loaded["state_dict"])
        epochs = []
        for _ in range(2):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            tr.train()
            torch.cuda.synchronize(device)
            epochs.append(time.perf_counter() - t0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"xe_step_ms": float(np.median(times[1:])), "xe_epoch_s": epochs[1],
            "xe_epoch_steps": len(tr.train_dataloader)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--child", choices=sorted(SETTINGS))
    parser.add_argument("--out", default=None, help="write the results as JSON here")
    args = parser.parse_args()
    if args.child:
        print(json.dumps(child(SETTINGS[args.child][1])), flush=True)
        return 0

    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        print("no CUDA device: this script times the card", file=sys.stderr)
        return 1
    print(chip_smoke.nvidia_smi_line(), flush=True)
    runs = {k: [] for k in SETTINGS}
    for name in ORDER:
        env = dict(os.environ)
        env.pop("CUBLAS_WORKSPACE_CONFIG", None)
        if SETTINGS[name][0] is not None:
            env["CUBLAS_WORKSPACE_CONFIG"] = SETTINGS[name][0]
        out = subprocess.run([sys.executable, __file__, "--child", name], env=env, cwd=ROOT,
                             capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            print(out.stdout[-2000:], out.stderr[-4000:], file=sys.stderr)
            return 1
        result = json.loads(out.stdout.strip().splitlines()[-1])
        runs[name].append(result)
        print(f"{name} (CUBLAS_WORKSPACE_CONFIG {SETTINGS[name][0]}, deterministic "
              f"{SETTINGS[name][1]}): {result}", flush=True)
    summary = {}
    for name, results in runs.items():
        summary[name] = {k: sorted(r[k] for r in results) for k in results[0]}
        print(f"{name}: XE step ms {summary[name]['xe_step_ms']}, trainer XE epoch s "
              f"{summary[name]['xe_epoch_s']} ({results[0]['xe_epoch_steps']} steps)")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"settings": {k: list(v) for k, v in SETTINGS.items()}, "runs": runs}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
