"""One rank of the port's model-parallel checks in
``tests/test_torch_port_tensor_expert_parallel.py`` and
``tests/test_torch_port_sequence_pipeline_parallel.py``, run as a process
of its own:

    RANK=r WORLD_SIZE=4 MASTER_ADDR=localhost MASTER_PORT=p \\
        python tests/torch_port_layouts_worker.py <tp_ep|sp_pp> <directory>

It imports torch, numpy and the port only (no JAX), starts the gloo group
from those variables through ``parallel.runtime.initialize_distributed``,
reads the test's inputs and weights from ``<directory>`` (``.npz`` drawn
with numpy, ``.json`` configs) and writes its results there as
``<job>_rank<r>.pt``.  Every rank makes every mesh, in one order (each
axis's subgroups are made collectively), and skips the cases of a mesh
that it is not part of.

``tp_ep``: the XE step under SGD at {data 2, model 2}, {model 2} and
{data 4} (losses, the full parameters after the steps, each sharded
parameter's local shape); Adam's moments after ``shard_state`` and one
step at {data 2, model 2}; the beam decode of a tensor-parallel model at
{model 2} (the default path and the head kernel's plain version) and its
refusals; the expert-parallel MoE encoder at {expert 4}: forward and the
gradients of sum(out ** 2).

``sp_pp``: ring and Ulysses self-attention at {seq 4} (plain, bias, key
mask, gradients; the ring given garbage in other ranks' K/V rows) and at
{data 2, seq 2}; the flagship and ORT encoders under the ring context, the
flagship under Ulysses at {data 2, seq 2} and its fallback to the ring on
indivisible heads; the geometry kernel's flag against the context; the
pipelined encoder at JAX's parametrisations, on {data 2, pipe 2}, with
gradients, and a generic stage."""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from openviic_tpu_torch.builders import build_model  # noqa: E402
from openviic_tpu_torch.compat.from_jax import load_jax_params  # noqa: E402
from openviic_tpu_torch.config import ConfigNode  # noqa: E402
from openviic_tpu_torch.data.vocab import Vocab  # noqa: E402
from openviic_tpu_torch.decoding import beam_search  # noqa: E402
from openviic_tpu_torch.models.encoders import Encoder  # noqa: E402
from openviic_tpu_torch.parallel import runtime  # noqa: E402
from openviic_tpu_torch.parallel import mesh as mp  # noqa: E402
from openviic_tpu_torch.parallel.pipeline import (  # noqa: E402
    pipeline_apply,
    pipelined_encoder_apply,
)
from openviic_tpu_torch.parallel.ring_attention import (  # noqa: E402
    DISPATCH_STATS as RING_STATS,
    ring_attention,
    ring_self_attention,
)
from openviic_tpu_torch.parallel.ulysses import (  # noqa: E402
    DISPATCH_STATS as ULYSSES_STATS,
    ulysses_self_attention,
)
from openviic_tpu_torch.training.optim import make_optimizer  # noqa: E402
from openviic_tpu_torch.parallel.tensor_parallel import full_tensors, shard_model  # noqa: E402
from openviic_tpu_torch.training.steps import init_xe_state, make_xe_step  # noqa: E402

SGD_LR = 0.05
SPECIALS = ["<pad>", "<bos>", "<eos>", "<unk>"]
XE_MESHES = (("dp2xtp2", {"data": 2, "model": 2}, [0, 1, 2, 3]),
             ("tp2", {"model": 2}, [0, 1]),
             ("dp4", {"data": 4}, [0, 1, 2, 3]))


def _load(directory, name):
    with np.load(os.path.join(directory, name)) as z:
        return {k: torch.from_numpy(v) for k, v in z.items()}


def _json(directory, name):
    with open(os.path.join(directory, name)) as f:
        return json.load(f)


def _vocab(job):
    return Vocab(SPECIALS + [f"w{i}" for i in range(job["vocab"] - len(SPECIALS))],
                 job["max_len"])


def _flat(directory, name):
    with np.load(os.path.join(directory, name)) as z:
        return dict(z)


def full_params(model, mesh) -> dict:
    return full_tensors({n: p.detach() for n, p in model.named_parameters()}, model, mesh)


# ------------------------------------------------------------------ tp_ep


def tp_ep(directory: str) -> dict:
    job = _json(directory, "tp.json")
    vocab = _vocab(job)
    flat = _flat(directory, "tp_params.npz")
    batches = _load(directory, "tp_batches.npz")
    out = {"xe": {}, "refusals": {}}

    def fresh():
        model = build_model(ConfigNode(job["model"]), vocab, device="cpu")
        return load_jax_params(model, flat)

    for name, axes, ranks in XE_MESHES:
        mesh = mp.make_mesh(axes, ranks)
        if mesh.coords is None:
            continue
        model = fresh()
        state = init_xe_state(model, torch.optim.SGD(model.parameters(), lr=SGD_LR), seed=0)
        mp.shard_state(model, state, mesh)
        step = mp.make_sharded_xe_step(model, mesh)
        losses = []
        for i in range(job["xe_steps"]):
            batch = mp.batch_shard({k[len(f"xe{i}_"):]: v for k, v in batches.items()
                                    if k.startswith(f"xe{i}_")}, mesh)
            state, loss = step(state, batch)
            losses.append(float(loss))
        out["xe"][name] = {"losses": losses, "params": full_params(model, mesh),
                           "local_shapes": {n: tuple(p.shape)
                                            for n, p in model.named_parameters()},
                           "moved": mesh.moved, "coords": mesh.coords}

    # Adam: a full-shape state (one step of every rank on the same batch
    # before the mesh), then shard_state and one sharded step
    mesh = mp.make_mesh({"data": 2, "model": 2})
    model = fresh()
    optimizer, scheduler = make_optimizer(model.parameters(), job["model"]["ENCODER"]["D_MODEL"],
                                          100)
    state = init_xe_state(model, optimizer, scheduler, seed=0)
    one = {k[len("xe0_"):]: v for k, v in batches.items() if k.startswith("xe0_")}
    state, _ = make_xe_step(model)(state, one)
    full_moments = {n: optimizer.state[p]["exp_avg"].clone() for n, p in model.named_parameters()}
    mp.shard_state(model, state, mesh)
    sliced = {n: optimizer.state[p]["exp_avg"].clone() for n, p in model.named_parameters()}
    state, _ = mp.make_sharded_xe_step(model, mesh)(state, mp.batch_shard(one, mesh))
    out["adam"] = {
        "coords": mesh.coords, "specs": model.parallel_specs,
        "full_moments": full_moments, "sliced_moments": sliced,
        "shapes": {n: {k: tuple(v.shape) for k, v in optimizer.state[p].items()
                       if torch.is_tensor(v)} for n, p in model.named_parameters()},
        "param_shapes": {n: tuple(p.shape) for n, p in model.named_parameters()},
        "step_counts": {n: float(optimizer.state[p]["step"]) for n, p in
                        model.named_parameters()},
    }

    # the tensor-parallel decode, and its refusals
    mesh = mp.make_mesh({"model": 2}, [0, 1])
    if mesh.coords is not None:
        model = fresh()
        model.eval()
        mp.shard_state(model, init_xe_state(model, torch.optim.SGD(model.parameters(), lr=0.0)),
                       mesh)
        feats = {"region_features": batches["decode_region_features"]}
        tokens, logprobs = beam_search(model, feats, beam_size=job["beam"])
        kernel_tokens, kernel_logprobs = beam_search(model, feats, beam_size=job["beam"],
                                                     head_kernel=1)
        out["decode"] = {"tokens": tokens, "logprobs": logprobs,
                         "kernel_tokens": kernel_tokens, "kernel_logprobs": kernel_logprobs}
        for flag in ("resident_kernel", "attn_kernel"):
            try:
                beam_search(model, feats, beam_size=job["beam"], **{flag: True})
                out["refusals"][flag] = None
            except ValueError as exc:
                out["refusals"][flag] = str(exc)

    # expert parallel: the MoE encoder at {expert 4}
    ep = _json(directory, "ep.json")
    inputs = _load(directory, "ep_inputs.npz")
    mesh = mp.make_mesh({"expert": 4})
    encoder = Encoder(ConfigNode(ep["encoder"]))
    load_jax_params(encoder, _flat(directory, "ep_params.npz"))
    encoder.eval()
    specs = shard_model(encoder, mesh)
    y = encoder(inputs["features"], inputs["padding_mask"])
    (y ** 2).sum().backward()
    out["ep"] = {"out": y.detach(), "grads": full_tensors({n: p.grad for n, p in encoder.named_parameters()},
                                          encoder, mesh), "specs": specs,
                 "local_shapes": {n: tuple(p.shape) for n, p in encoder.named_parameters()},
                 "moved": mesh.moved}
    return out


# ------------------------------------------------------------------ sp_pp


def _attention_cases(directory: str) -> dict:
    arrays = _load(directory, "sp_arrays.npz")
    out = {}
    mesh = mp.make_mesh({"seq": 4})
    for fn_name, fn in (("ring", ring_self_attention), ("ulysses", ulysses_self_attention)):
        out[f"{fn_name}_plain"] = fn(arrays["q0"], arrays["k0"], arrays["v0"], mesh)
        out[f"{fn_name}_bias"] = fn(arrays["q1"], arrays["k1"], arrays["v1"], mesh,
                                    bias=arrays["bias1"])
        out[f"{fn_name}_mask"] = fn(arrays["q3"], arrays["k3"], arrays["v3"], mesh,
                                    key_mask=arrays["mask3"])
        q, k, v = (arrays[f"{n}7"].clone().requires_grad_(True) for n in "qkv")
        (fn(q, k, v, mesh) ** 2).sum().backward()
        out[f"{fn_name}_grads"] = (q.grad, k.grad, v.grad)
    # the ring body reads only this rank's K/V rows: garbage elsewhere
    n_local = arrays["k0"].shape[1] // 4
    i = mesh.index("seq")
    mine = torch.zeros(arrays["k0"].shape[1], dtype=torch.bool)
    mine[i * n_local:(i + 1) * n_local] = True
    garbage = torch.full_like(arrays["k0"], 1e6)
    k = torch.where(mine[None, :, None, None], arrays["k0"], garbage)
    v = torch.where(mine[None, :, None, None], arrays["v0"], -garbage)
    out["ring_garbage"] = ring_self_attention(arrays["q0"], k, v, mesh)
    dmesh = mp.make_mesh({"data": 2, "seq": 2})
    for fn_name, fn in (("ring", ring_self_attention), ("ulysses", ulysses_self_attention)):
        out[f"{fn_name}_data_seq"] = fn(arrays["q4"], arrays["k4"], arrays["v4"], dmesh,
                                        bias=arrays["bias4"], key_mask=arrays["mask4"],
                                        batch_axis="data")
    out["moved"] = {"seq": mesh.moved, "data_seq": dmesh.moved}
    return out


def _encoder_cases(directory: str) -> dict:
    job = _json(directory, "sp_encoders.json")
    vocab = _vocab(job)
    batch = _load(directory, "sp_region_batch.npz")
    out = {}
    seq4 = mp.make_mesh({"seq": 4})
    data_seq = mp.make_mesh({"data": 2, "seq": 2})
    for name in ("flagship", "ort"):
        model = build_model(ConfigNode(job[name]), vocab, device="cpu")
        load_jax_params(model, _flat(directory, f"sp_{name}_params.npz"))
        model.eval()
        with torch.no_grad():
            before = dict(ring=RING_STATS["calls"], ulysses=ULYSSES_STATS["calls"])
            with ring_attention(seq4, "seq"):
                feats, _ = model.encoder_forward(batch)
            out[f"{name}_ring"] = feats
            out[f"{name}_ring_calls"] = RING_STATS["calls"] - before["ring"]
            if name == "flagship":
                before = dict(ring=RING_STATS["calls"], ulysses=ULYSSES_STATS["calls"])
                with ring_attention(data_seq, "seq", batch_axis="data", mode="ulysses"):
                    out["flagship_ulysses"], _ = model.encoder_forward(batch)
                out["flagship_ulysses_calls"] = (ULYSSES_STATS["calls"] - before["ulysses"],
                                                 RING_STATS["calls"] - before["ring"])
                before = dict(ring=RING_STATS["calls"], ulysses=ULYSSES_STATS["calls"])
                # two heads on a 4-wide axis: Ulysses cannot, the ring does
                with ring_attention(seq4, "seq", mode="ulysses"):
                    out["flagship_fallback"], _ = model.encoder_forward(batch)
                out["flagship_fallback_calls"] = (ULYSSES_STATS["calls"] - before["ulysses"],
                                                  RING_STATS["calls"] - before["ring"])
        if name == "ort":
            trig = build_model(ConfigNode(job["ort_trig"]), vocab, device="cpu")
            load_jax_params(trig, _flat(directory, "sp_ort_trig_params.npz"))
            trig.eval()
            os.environ["OPENVIIC_GEO_FUSED"] = "1"
            try:
                before = RING_STATS["calls"]
                with torch.no_grad(), ring_attention(seq4, "seq"):
                    out["ort_geo_fused"], _ = trig.encoder_forward(batch)
                out["ort_geo_fused_ring_calls"] = RING_STATS["calls"] - before
            finally:
                del os.environ["OPENVIIC_GEO_FUSED"]
    return out


def _pipeline_cases(directory: str) -> dict:
    job = _json(directory, "pp.json")
    arrays = _load(directory, "pp_arrays.npz")
    out = {}
    for layers, pipe, micro in job["cases"]:
        mesh = mp.make_mesh({"pipe": pipe}, list(range(pipe)))
        if mesh.coords is None:
            continue
        encoder = Encoder(ConfigNode(job[f"encoder_{layers}"])).eval()
        load_jax_params(encoder, _flat(directory, f"pp_params_{layers}.npz"))
        with torch.no_grad():
            out[f"l{layers}p{pipe}m{micro}"] = pipelined_encoder_apply(
                encoder, arrays["features"], arrays["padding_mask"], mesh=mesh,
                microbatches=micro)
        out[f"l{layers}p{pipe}m{micro}_layers"] = len(encoder.layers)
    mesh = mp.make_mesh({"data": 2, "pipe": 2})
    encoder = Encoder(ConfigNode(job["encoder_4"])).eval()
    load_jax_params(encoder, _flat(directory, "pp_params_4.npz"))
    with torch.no_grad():
        out["dp_pp"] = pipelined_encoder_apply(encoder, arrays["features"],
                                               arrays["padding_mask"], mesh=mesh,
                                               microbatches=2, batch_axis="data")
    # gradients at pipe 4, one layer a stage: each rank's own layer's
    mesh = mp.make_mesh({"pipe": 4})
    encoder = Encoder(ConfigNode(job["encoder_4"])).eval()
    load_jax_params(encoder, _flat(directory, "pp_params_4.npz"))
    y = pipelined_encoder_apply(encoder, arrays["features"], arrays["padding_mask"], mesh=mesh,
                                microbatches=4)
    (y ** 2).sum().backward()
    first = encoder.pipeline_stage[0]
    grads = {}
    for name, p in encoder.named_parameters():
        if name.startswith("layers."):
            parts = name.split(".")
            name = ".".join(["layers", str(first + int(parts[1]))] + parts[2:])
        grads[name] = p.grad.detach().clone()
    out["grads"] = grads
    out["stage"] = encoder.pipeline_stage
    out["pipe_moved"] = mesh.moved
    # a generic stage: four (D, D) weights stacked, tanh(h @ w)
    w, x = arrays["generic_w"], arrays["generic_x"]
    out["generic"] = pipeline_apply(lambda wi, h, _aux: torch.tanh(h @ wi), w, x, mesh=mesh,
                                    microbatches=4)
    return out


def sp_pp(directory: str) -> dict:
    out = {"attention": _attention_cases(directory)}
    out["encoders"] = _encoder_cases(directory)
    out["pipeline"] = _pipeline_cases(directory)
    return out


def main() -> int:
    job, directory = sys.argv[1], sys.argv[2]
    torch.set_num_threads(1)
    assert runtime.initialize_distributed("cpu")
    try:
        result = (tp_ep if job == "tp_ep" else sp_pp)(directory)
        result["rank"] = runtime.process_index()
    finally:
        runtime.shutdown()
    torch.save(result, os.path.join(directory, f"{job}_rank{result['rank']}.pt"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
