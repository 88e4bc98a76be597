"""Which collectives gloo runs on CUDA tensors itself (on the card):

    python -m openviic_tpu_torch.parallel.gloo_probe

For each collective of ``openviic_tpu_torch/parallel/collectives.py``
(all-reduce sum and max, broadcast, all-gather, all-to-all, a send and
receive pair) it starts two ranks of their own on ``cuda:0`` over gloo
(``parallel.dryrun.start``, torchrun's variables; all the pairs at once),
which run that op once on CUDA tensors without staging, under a 30 s group
timeout, and check the result.  An op that raises, returns a wrong value,
hangs or kills its ranks is one that gloo does not take.  It prints one
JSON object, {op: "ok" or what happened}, and ``probe ok``.
``collectives.GLOO_CUDA`` lists the ops found to work."""

from __future__ import annotations

import datetime
import json
import os
import sys
import tempfile

import torch
import torch.distributed as dist

OPS = ("all_reduce", "all_reduce_max", "broadcast", "all_gather", "all_to_all", "send_recv")


def rank_probe(op: str) -> str:
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", timeout=datetime.timedelta(seconds=30))
    rank, world = dist.get_rank(), dist.get_world_size()
    x = torch.full((4,), float(rank + 1), device="cuda")
    want = None
    if op == "all_reduce":
        dist.all_reduce(x)
        got, want = x, torch.full((4,), 3.0, device="cuda")
    elif op == "all_reduce_max":
        dist.all_reduce(x, op=dist.ReduceOp.MAX)
        got, want = x, torch.full((4,), 2.0, device="cuda")
    elif op == "broadcast":
        dist.broadcast(x, 0)
        got, want = x, torch.ones(4, device="cuda")
    elif op == "all_gather":
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        got, want = torch.cat(parts), torch.tensor([1.0] * 4 + [2.0] * 4, device="cuda")
    elif op == "all_to_all":
        got = torch.empty_like(x)
        dist.all_to_all_single(got, x)
        want = torch.tensor([1.0, 1.0, 2.0, 2.0], device="cuda")
    else:
        got = torch.empty_like(x)
        for work in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, (rank + 1) % world),
                                            dist.P2POp(dist.irecv, got, (rank - 1) % world)]):
            work.wait()
        want = torch.full((4,), float((rank - 1) % world + 1), device="cuda")
    torch.cuda.synchronize()
    ok = torch.equal(got, want)
    dist.destroy_process_group()
    return "ok" if ok else f"wrong values {got.tolist()} (expected {want.tolist()})"


def main() -> int:
    if "--worker" in sys.argv:
        op, out_dir = sys.argv[-2], sys.argv[-1]
        result = rank_probe(op)
        with open(os.path.join(out_dir, f"result{os.environ['RANK']}.json"), "w") as f:
            json.dump(result, f)
        return 0
    from openviic_tpu_torch.parallel import dryrun

    if not torch.cuda.is_available():
        print("no CUDA device: the probe needs an NVIDIA GPU", file=sys.stderr)
        return 1
    out = {}
    with tempfile.TemporaryDirectory(prefix="openviic_gloo_probe_") as tmp:
        started = {}
        for op in OPS:
            d = os.path.join(tmp, op)
            os.makedirs(d)
            started[op] = (d, dryrun.start(["-m", "openviic_tpu_torch.parallel.gloo_probe",
                                            "--worker", op, d], 2, d))
        for op, (d, procs) in started.items():
            try:
                dryrun.wait(procs, d, 120)
                results = []
                for r in range(2):
                    with open(os.path.join(d, f"result{r}.json")) as f:
                        results.append(json.load(f))
                out[op] = "ok" if results == ["ok", "ok"] else " | ".join(results)
            except AssertionError as exc:  # a rank raised, died or hung
                lines = [ln for ln in str(exc).splitlines() if "Error" in ln]
                out[op] = (lines[-1] if lines else str(exc).splitlines()[0])[:300]
    print(json.dumps(out), flush=True)
    print("probe ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
