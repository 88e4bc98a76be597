"""A multi-process dry run of the model-parallel layouts (the port's
counterpart of the layout stages of ``__graft_entry__.py``'s
``_dryrun_multichip_impl``):

    python -m openviic_tpu_torch.parallel.layouts_dryrun [--device cuda:0]
        [--backend gloo] [--d-model 64 --heads 4 --layers 3 --d-ff 128 ...]

It spawns four ranks (``dryrun.start``: torchrun's variables), every one on
``--device`` over ``--backend`` (on one card only gloo can carry several
ranks: NCCL refuses two ranks on one device), after running one process's
references on the same device alone.  Random weights from a seed, dropout
0, f32 unless said.  The cases, each against one process:

 (a) tensor parallel XE: {data 2, model 2} under SGD (losses within
     ``LOSS_RTOL``, parameters within 2e-4 / 1e-5) and {model 2} under
     Adam (losses; each rank's bytes of the sharded parameters and their
     moments half of one process's), ``--steps`` steps at
     ``--global-batch``;
 (b) tensor-parallel decode at {model 2} over ``--images`` images, beam
     ``--beam``: at f32 the tokens equal; at bf16 with ``head_kernel=1``
     (``head_topk`` on each rank's vocab shard, once a step) the mean
     best-beam log-prob is within ``SCORE_RTOL`` and, teacher-forced along
     the ranks' best captions, each token's log-prob within ``FORCED_ATOL``
     of one process's on ``FORCED_SHARE`` of the tokens (bf16 rounding
     apart, the two are one computation); the captions' agreement is
     reported beside that of a second witness (one process with
     ``OPENVIIC_PALLAS=1``, its encoder attention rounded otherwise), the
     agreement that rounding alone gives these random weights;
 (c) the {model 2} encoder under ``OPENVIIC_PALLAS=1``: ``fused_attention``
     once a layer on each rank's heads, the output within ``KERNEL_ATOL``;
 (d) the flagship encoder under the ring and under Ulysses at {data 2, seq
     2}, and the ORT encoder (trig embedding off) under the ring: forward
     within 2e-5, gradients of sum(out ** 2) within 1e-4 of the largest
     gradient (of any leaf), one call a layer;
 (e) the encoder pipelined at {pipe 3} over ranks 0-2 (a layer a stage,
     ``--microbatches``): forward within 1e-5, gradients within 2e-4 of
     the largest gradient and 1e-4 relative; under ``OPENVIIC_PALLAS=1`` a
     forward with ``fused_attention`` once a microbatch on each stage;
 (f) a Switch MoE encoder of ``--experts`` experts at {expert 4}: forward
     within 1e-5, gradients as (e).

With ``--family NAME[,NAME...]`` (``all``: every name of ``FAMILY_NAMES``)
it runs the families' cases instead (``families_run``), each family at
the widths given (``family_model``: at the flagship's widths, each its
yaml's tree at dropout 0), its ``model`` axis over ranks 0-1 or 2-3 (the
families alternate between the two), every case against one process:

 (g) each family at {model 2}: one f32 XE step at ``--family-batch``
     (the loss within ``LOSS_RTOL``); the f32 decode of ``--f32-images``
     images on the eager path (tokens equal); the bf16 decode of
     ``--images`` images on the tuned path (``head_kernel=1`` and
     ``attn_kernel``, each rank's vocab shard and heads): the mean
     best-beam log-prob within ``SCORE_RTOL`` and, teacher-forced along
     the ranks' best captions, each token's log-prob within
     ``FORCED_ATOL`` of one process's on ``FORCED_SHARE`` of the tokens
     (the same bar along the captions of each path of (h) and (i));
     RSTNet decodes through its signal table, built on each rank;
 (h) the flagship (``flagship`` among the names) at {model 2} on ranks
     0-1: path (b), ``resident_kernel`` (``resident_layer_step`` on every
     rank, the layer's weights gathered once a decode), and path (c),
     non-resident under ``OPENVIIC_FUSED_STEP=1`` (``fused_layer_step``),
     each at bf16 with the head kernel; then path (a) at {model 4} over
     all four ranks (``beam_select_attention`` on one head of two, its
     general kernel; at {model 2}, (g)'s tuned path runs its fast kernel);
     each within ``SCORE_RTOL`` of one process's on the same path and
     under (g)'s forced bar along its own captions, every kernel launched
     once a layer and step on each rank.  These kernels take bf16 tensors
     only on the card, so their paths run at bf16, where a rounding of the
     sharded sums can move a near tie, and no path of (h) is held to
     equal tokens;
 (i) the ORT with the trig embedding (``ort_trig``) at {model 2} under
     ``OPENVIIC_GEO_FUSED=1``: ``geo_fused_attention`` once a layer on
     the rank's heads, within ``SCORE_RTOL`` of one process's and under
     (g)'s forced bar.

With ``--capture DIR`` rank 0 keeps the kernels' inputs: ``head_topk`` at
decode steps 0, 12 and 24 of (b) and ``fused_attention``'s first call of
(c) and of (e)'s flagged forward, in ``DIR/captured.pt`` (the families'
run: each layer kernel's and the beam-select kernel's inputs at step
``CAPTURE_STEPS[1]`` of its path, the {model 4} one too, and the geometry
kernel's first call).  It prints one
JSON summary (ms a step, a decode or a forward; bytes each axis moved;
the ops staged through the host; launches) and ``layouts dryrun ok``; any
failure raises.  ``single_rank(options)`` is the check of one rank in this
process: every axis of size 1 over ``--backend``, each layout bit-equal to
no process group."""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from openviic_tpu_torch.parallel import dryrun

LOSS_RTOL = dryrun.LOSS_RTOL
PARAM_RTOL, PARAM_ATOL = dryrun.PARAM_RTOL, dryrun.PARAM_ATOL
ENCODER_ATOL, ENCODER_GRAD = 2e-5, 1e-4  # ring / Ulysses: forward, gradients (of their scale)
PIPE_ATOL, PIPE_GRAD_ATOL, PIPE_GRAD_RTOL = 1e-5, 2e-4, 1e-4  # also the MoE's
KERNEL_ATOL = 1e-4  # an encoder through fused_attention, tensor-parallel against one process
SCORE_RTOL = 0.005  # the bf16 decode's mean best-beam log-prob against one process's
# the bf16 decode's per-token log-probs along its best captions, teacher-forced,
# against one process's: two bf16 ulps of a logit in [16, 32) on 99% of the tokens
FORCED_ATOL, FORCED_SHARE = 0.25, 0.99
NPROCS = 4
CAPTURE_STEPS = (0, 12, 24)
XE_CASES = (("dp2_tp2", {"data": 2, "model": 2}, (0, 1, 2, 3), "sgd"),
            ("tp2", {"model": 2}, (0, 1), "adam"))


def parse(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="model-parallel layouts across processes")
    p.add_argument("--device", default="cuda:0", help="every rank's device (cuda:<i> or cpu)")
    p.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    p.add_argument("--d-model", type=int, default=64)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--layers", type=int, default=3)
    p.add_argument("--d-ff", type=int, default=128)
    p.add_argument("--d-feature", type=int, default=32)
    p.add_argument("--regions", type=int, default=8)
    p.add_argument("--vocab", type=int, default=64)
    p.add_argument("--max-len", type=int, default=10)
    p.add_argument("--global-batch", type=int, default=8)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--warmup", type=int, default=100)
    p.add_argument("--images", type=int, default=8)
    p.add_argument("--beam", type=int, default=3)
    p.add_argument("--microbatches", type=int, default=4)
    p.add_argument("--experts", type=int, default=4)
    p.add_argument("--family", default=None,
                   help="run the families' cases: comma-separated FAMILY_NAMES, or all")
    p.add_argument("--family-batch", type=int, default=4, help="the families' XE batch")
    p.add_argument("--f32-images", type=int, default=4, help="the families' f32 decode")
    p.add_argument("--lm-hidden", type=int, default=32, help="RSTNet's language model width")
    p.add_argument("--lm-vocab", type=int, default=320, help="RSTNet's language model vocab")
    p.add_argument("--threads", type=int, default=0, help="torch threads a process (0: torch's)")
    p.add_argument("--timeout", type=float, default=600.0, help="seconds for the ranks")
    p.add_argument("--capture", default=None, help="keep rank 0's kernel inputs here")
    p.add_argument("--out", default=None, help="the run's directory (default: a temporary one)")
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    return p.parse_args(argv)


# ------------------------------------------------------------- inputs


FAMILY_NAMES = ("flagship", "aoa", "augmented_memory", "meshed_memory", "camo", "ort",
                "ort_trig", "dlct", "rstnet", "moe_lstm")
GRID_SIDE = 7  # DLCT's grid: 7 x 7 cells


def family_model(opts, family: str = "flagship", dropout: float = 0.0) -> dict:
    """The MODEL tree of ``family`` at the options' widths: at the
    flagship's widths (d_model 512, 8 heads, d_ff 2048, 3 + 3 layers,
    1024-d features; RSTNet's language model at ``--lm-hidden`` 768 over
    ``--lm-vocab`` 64 001) the tree of its yaml under ``configs/``
    (``tests/test_torch_port_families_configs.py`` holds it to that):
    ``flagship`` standard_transformer_using_region (the dry run's
    artifact tree), ``aoa`` attention_on_attention, ``augmented_memory``,
    ``meshed_memory``, ``camo`` (a one-head encoder attention of d_k
    d_model / heads), ``ort`` object_relation_transformer and ``ort_trig``
    the same with the trig embedding, ``dlct`` dlct_fixed, ``rstnet``
    rstnet_fixed; ``moe_lstm`` is the flagship with an ``--experts``-expert
    Switch MoE on every FFN and ``LSTMTextEmbedding``.  ``dropout``: every
    DROPOUT of the families built here (the yamls' is 0.1); the flagship
    and ``moe_lstm`` keep the dry run's 0."""
    d, h, ff, layers = opts.d_model, opts.heads, opts.d_ff, opts.layers

    def attn(arch="ScaledDotProductAttention", heads=h, stateful=False, slots=False,
             aoa=False):
        node = {"ARCHITECTURE": arch, "HEAD": heads, "D_MODEL": d, "D_KEY": d // h,
                "D_VALUE": d // h, "D_FF": ff, "D_FEATURE": ff, "USE_AOA": aoa,
                "CAN_BE_STATEFUL": stateful, "DROPOUT": dropout}
        return dict(node, MEMORY=40) if slots else node

    text = {"ARCHITECTURE": "UsualEmbedding", "D_MODEL": d, "D_EMBEDDING": 300,
            "WORD_EMBEDDING": None, "WORD_EMBEDDING_CACHE": None, "DROPOUT": dropout}

    def tree(architecture, encoder, decoder, enc_attention, dec_attention, vision=None, **extra):
        return {
            "ARCHITECTURE": architecture, "NAME": f"layouts_{family}", "DEVICE": "tpu",
            "VISION_EMBEDDING": vision or {"ARCHITECTURE": "FeatureEmbedding",
                                           "D_FEATURE": opts.d_feature, "D_MODEL": d,
                                           "DROPOUT": dropout},
            "ENCODER": dict({"ARCHITECTURE": encoder, "D_MODEL": d, "LAYERS": layers,
                             "SELF_ATTENTION": enc_attention}, **extra),
            "DECODER": {"ARCHITECTURE": decoder, "D_MODEL": d, "LAYERS": layers,
                        "ATTENTION": dec_attention, "TEXT_EMBEDDING": text},
        }

    if family in ("flagship", "moe_lstm"):  # the dry run's own tree, dropout 0
        model = dryrun._config(opts).to_dict()
        if family == "moe_lstm":
            model["ENCODER"]["SELF_ATTENTION"]["MOE_EXPERTS"] = opts.experts
            model["DECODER"]["ATTENTION"]["ENC_ATTENTION"]["MOE_EXPERTS"] = opts.experts
            model["DECODER"]["TEXT_EMBEDDING"].update(ARCHITECTURE="LSTMTextEmbedding",
                                                      D_EMBEDDING=d)
        return model
    dec = {"SELF_ATTENTION": attn(stateful=True), "ENC_ATTENTION": attn()}
    if family in ("ort", "ort_trig"):  # its yaml's attentions name no D_FEATURE
        def bare(node):
            return {k: v for k, v in node.items() if k != "D_FEATURE"}
        return tree("ObjectRelationTransformer", "GeometricEncoder", "Decoder",
                    bare(attn("AugmentedGeometryScaledDotProductAttention")),
                    {k: bare(v) for k, v in dec.items()},
                    TRIGNOMETRIC_EMBEDDING=family == "ort_trig")
    if family == "aoa":
        return tree("StandardTransformerUsingRegion", "Encoder", "Decoder",
                    attn(slots=True, aoa=True),
                    {"SELF_ATTENTION": attn(stateful=True, aoa=True),
                     "ENC_ATTENTION": attn(aoa=True)})
    memory = "AugmentedMemoryScaledDotProductAttention"
    if family == "augmented_memory":
        return tree("MeshedMemoryTransformer", "Encoder", "Decoder",
                    attn(memory, slots=True), dict(dec, N_ENCODER_LAYERS=layers, D_MODEL=d))
    if family == "meshed_memory":
        return tree("MeshedMemoryTransformer", "MultilevelEncoder", "MeshedDecoder",
                    attn(memory, slots=True), dict(dec, N_ENCODER_LAYERS=layers, D_MODEL=d))
    if family == "camo":
        return tree("CamoTransformer", "CrossAttentionMultiLevelEncoder", "Decoder",
                    attn(heads=1, slots=True), dec)
    if family == "dlct":
        geometric = attn("AugmentedGeometryScaledDotProductAttention")
        return tree("DLCTTransformer", "DualCollaborativeLevelEncoder", "Decoder", geometric,
                    dec, vision={"ARCHITECTURE": "GeometricDualFeatureEmbedding",
                                 "D_REGION_FEATURE": opts.d_feature,
                                 "D_GRID_FEATURE": 2 * opts.d_feature, "D_MODEL": d,
                                 "DROPOUT": dropout},
                    HEAD=h, TRIGNOMETRIC_EMBEDDING=True, CROSS_ATTENTION=dict(geometric))
    if family == "rstnet":
        adaptive = "AdaptiveScaledDotProductAttention"
        out = tree("StandardTransformerUsingRegion", "Encoder", "AdaptiveDecoder",
                   attn(slots=True), dec)
        out["DECODER"].update(
            ADAPTIVE_ATTENTION={"SELF_ATTENTION": attn(adaptive, stateful=True),
                                "ENC_ATTENTION": attn(adaptive)},
            LANGUAGE_MODEL={
                "SIGNAL_MODE": "token", "ARCHITECTURE": "PhoBERTModel",
                "PRETRAINED_NAME": "vinai/phobert-base", "HIDDEN_SIZE": opts.lm_hidden,
                "D_MODEL": d, "MAX_LEN": 54, "VOCAB_SIZE": opts.lm_vocab, "PADDING_IDX": 0,
                "BACKBONE_LAYERS": 2, "BACKBONE_HEADS": 8, "ATTENTION": attn()})
        return out
    raise ValueError(f"unknown family {family!r}; the dry run's are {FAMILY_NAMES}")


def _model_config(opts, family: str = "flagship"):
    from openviic_tpu_torch.config import ConfigNode

    if family == "moe":  # the MoE encoder of case (f)
        model = dryrun._config(opts).to_dict()
        model["ENCODER"]["SELF_ATTENTION"]["MOE_EXPERTS"] = opts.experts
        return ConfigNode(model)
    return ConfigNode(family_model(opts, family))


def _model(opts, device, family: str = "flagship", seed: int = 0):
    from openviic_tpu_torch.builders import build_model

    return build_model(_model_config(opts, family), dryrun._vocab(opts), device=device,
                       seed=seed).eval()


def images(opts, device) -> Dict[str, torch.Tensor]:
    """``--images`` images: f32 regions with a ragged count of zero rows and
    their boxes in pixels of a 640 x 480 image (zero where the row is)."""
    rng = np.random.default_rng(7)
    n, r = opts.images, opts.regions
    feats = rng.normal(size=(n, r, opts.d_feature)).astype(np.float32)
    x0, y0 = rng.uniform(0, 560, (n, r)), rng.uniform(0, 400, (n, r))
    w, h = rng.uniform(4, 80, (n, r)), rng.uniform(4, 80, (n, r))
    boxes = np.stack([x0, y0, x0 + w, y0 + h], axis=-1).astype(np.float32)
    for i in range(n):
        feats[i, r - i % 3:] = 0.0
        boxes[i, r - i % 3:] = 0.0
    return {"region_features": torch.from_numpy(feats).to(device),
            "region_boxes": torch.from_numpy(boxes).to(device)}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(device, fn):
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, 1e3 * (time.perf_counter() - t0)


def _encoder_out(model, batch):
    feats, _ = model.encoder_forward(batch)
    return feats


def _grads(model) -> Dict[str, torch.Tensor]:
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()
            if p.grad is not None}


def _forward_backward(model, batch, device):
    """The encoder's output and the gradients of sum(out ** 2), timed."""
    model.zero_grad(set_to_none=True)

    def run():
        out = _encoder_out(model, batch)
        (out ** 2).sum().backward()
        return out.detach()

    out, ms = _timed(device, run)
    return out, _grads(model), ms


@contextlib.contextmanager
def _capture(module, name: str, keep: Dict[int, tuple], calls=None):
    """Wrap ``module.<name>``: copies of the arguments of the calls whose
    index is in ``calls`` (every call when None) go to ``keep``."""
    real = getattr(module, name)
    count = [0]

    def wrapper(*args, **kwargs):
        if calls is None or count[0] in calls:
            keep[count[0]] = tuple(a.detach().clone() if torch.is_tensor(a) else a
                                   for a in args), dict(kwargs)
        count[0] += 1
        return real(*args, **kwargs)

    setattr(module, name, wrapper)
    try:
        yield keep
    finally:
        setattr(module, name, real)


# ------------------------------------------------------------- references


def _xe_run(opts, device, mesh, optimizer_name: str):
    """``--steps`` XE steps from seed-0 weights on this rank's rows: losses,
    ms a step, the model and the optimizer."""
    from openviic_tpu_torch.parallel import mesh as mp
    from openviic_tpu_torch.training.optim import make_optimizer
    from openviic_tpu_torch.training.steps import init_xe_state

    model = _model(opts, device)
    if optimizer_name == "sgd":
        optimizer, scheduler = torch.optim.SGD(model.parameters(), lr=dryrun.SGD_LR), None
    else:
        optimizer, scheduler = make_optimizer(model.parameters(), opts.d_model, opts.warmup)
    state = init_xe_state(model, optimizer, scheduler, seed=42)
    mp.shard_state(model, state, mesh)
    step = mp.make_sharded_xe_step(model, mesh)
    vocab = dryrun._vocab(opts)
    losses, ms = [], []
    for s in range(opts.steps):
        batch = {k: v.to(device) for k, v in
                 mp.batch_shard(dryrun.global_batch(opts, vocab, s), mesh).items()}
        (state, loss), spent = _timed(device, lambda: step(state, batch))
        losses.append(float(loss))
        ms.append(spent)
    return losses, ms, model, optimizer


def _sharded_bytes(model, optimizer, names) -> int:
    """Bytes of the parameters ``names`` and of their optimizer tensors."""
    total = 0
    for name, p in model.named_parameters():
        if name in names:
            total += p.numel() * p.element_size()
            for value in optimizer.state.get(p, {}).values():
                if torch.is_tensor(value) and value.dim():
                    total += value.numel() * value.element_size()
    return total


def _teacher_forced(model, batch, tokens, vocab) -> torch.Tensor:
    """Each token's log-prob (f32) under teacher forcing along ``tokens``
    (each image's best caption: words, <eos>, then pad), NaN past the
    first <eos>."""
    tokens = tokens.to(batch["region_features"].device)
    bos = torch.full_like(tokens[:, :1], vocab.bos_idx)
    caption = torch.cat([bos, tokens[:, :-1]], dim=1)
    feats = batch["region_features"].to(next(model.parameters()).dtype)  # as a decode casts
    lp = model({"region_features": feats, "caption_tokens": caption})
    picked = lp.float().gather(-1, tokens[..., None])[..., 0]
    ended = torch.cumsum((tokens == vocab.eos_idx).int(), dim=1) - (tokens == vocab.eos_idx).int()
    return picked.masked_fill(ended > 0, float("nan")).cpu()


def _bf16(model):
    """A bf16 copy of ``model`` (a tensor-parallel one keeps its mesh)."""
    import copy

    return copy.deepcopy(model).to(torch.bfloat16)


def _decode(model, batch, opts, **kwargs):
    from openviic_tpu_torch.decoding import beam_search

    tokens, logprobs = beam_search(model, {"region_features": batch["region_features"]},
                                   beam_size=opts.beam, early_exit=False, **kwargs)
    return tokens.cpu(), logprobs.float().sum(-1).cpu()


def references(opts, device) -> dict:
    """One process's side of every case, alone on ``device``."""
    from openviic_tpu_torch.parallel import mesh as mp
    from openviic_tpu_torch.parallel.tensor_parallel import param_shardings

    one = mp.make_mesh()
    out = {"xe": {}}
    for name, _, _, optimizer_name in XE_CASES:
        losses, ms, model, optimizer = _xe_run(opts, device, one, optimizer_name)
        specs = param_shardings(model, mp.Mesh({"model": 2}, [0, 1], 0, {}, {}))
        out["xe"][name] = {"losses": losses, "ms": ms,
                           "params": {n: p.detach().cpu() for n, p in model.named_parameters()},
                           "sharded_bytes": _sharded_bytes(model, optimizer,
                                                           {n for n, s in specs.items() if s})}
    batch = images(opts, device)
    model = _model(opts, device)
    with torch.no_grad():
        out["decode_f32"], out["decode_f32_ms"] = _timed(device, lambda: _decode(model, batch,
                                                                                opts))
        out["decode_bf16"], out["decode_bf16_ms"] = _timed(device, lambda: _decode(
            model, batch, opts, head_kernel=1, compute_dtype=torch.bfloat16))
        # a second witness: the same model with its encoder attention through
        # the fused kernel, whose roundings differ: the caption agreement that
        # bf16 rounding of the hidden states alone gives these random weights
        with dryrun_env("OPENVIIC_PALLAS"):
            out["decode_bf16_witness"] = _decode(model, batch, opts, head_kernel=1,
                                                 compute_dtype=torch.bfloat16)
        with dryrun_env("OPENVIIC_PALLAS"):
            out["pallas"] = _encoder_out(model, batch).cpu()
    for family in ("flagship", "ort", "moe"):
        y, grads, ms = _forward_backward(_model(opts, device, family), batch, device)
        out[family] = {"out": y.cpu(), "grads": {n: g.cpu() for n, g in grads.items()},
                       "ms": ms}
    model = _model(opts, device)
    features, mask = model.vision_embedding(batch["region_features"])
    y = model.encoder(features.detach(), mask)
    (y ** 2).sum().backward()
    out["pipe"] = {"out": y.detach().cpu(),
                   "grads": {n: p.grad.cpu() for n, p in model.encoder.named_parameters()}}
    return out


@contextlib.contextmanager
def dryrun_env(name: str, value: str = "1"):
    before = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if before is None:
            del os.environ[name]
        else:
            os.environ[name] = before


# ------------------------------------------------------------- the ranks


def _moved(mesh) -> dict:
    return {"moved": {a: dict(ops) for a, ops in mesh.moved.items()},
            "grad_allreduce_bytes": mesh.allreduced_bytes, "staged": sorted(mesh.staged)}


def rank_run(opts, out_dir: str) -> dict:
    """One rank's cases (see the module's docstring); every rank makes
    every mesh in one order and skips the cases of a mesh it is outside."""
    from openviic_tpu_torch.models import attention as attention_module
    from openviic_tpu_torch.ops.fused_attention import fused_attention
    from openviic_tpu_torch.ops.head_topk import head_topk
    from openviic_tpu_torch.parallel import mesh as mp
    from openviic_tpu_torch.parallel import runtime, tensor_parallel
    from openviic_tpu_torch.parallel.pipeline import pipelined_encoder_apply
    from openviic_tpu_torch.parallel.ring_attention import DISPATCH_STATS as RING_STATS
    from openviic_tpu_torch.parallel.ring_attention import ring_attention
    from openviic_tpu_torch.parallel.ulysses import DISPATCH_STATS as ULYSSES_STATS

    device = torch.device(opts.device)
    rank = runtime.process_index()
    res: dict = {"rank": rank, "xe": {}}
    capture = opts.capture is not None and rank == 0
    captured: dict = {}
    for name, axes, ranks, optimizer_name in XE_CASES:
        mesh = mp.make_mesh(axes, list(ranks))
        if mesh.coords is None:
            continue
        losses, ms, model, optimizer = _xe_run(opts, device, mesh, optimizer_name)
        specs = model.parallel_specs
        res["xe"][name] = dict(
            losses=losses, ms=ms,
            sharded_bytes=_sharded_bytes(model, optimizer, {n for n, s in specs.items() if s}),
            **_moved(mesh))  # before the gathers below
        res["xe"][name]["params"] = (tensor_parallel.full_tensors(
            {n: p.detach() for n, p in model.named_parameters()}, model, mesh)
            if optimizer_name == "sgd" else None)

    batch = images(opts, device)
    mesh = mp.make_mesh({"model": 2}, [0, 1])
    if mesh.coords is not None:
        model = _model(opts, device)
        tensor_parallel.shard_model(model, mesh)
        with torch.no_grad():
            (tokens, lp), ms32 = _timed(device, lambda: _decode(model, batch, opts))
            before = head_topk.launches
            keep: dict = {}
            with _capture(tensor_parallel, "head_topk", keep, CAPTURE_STEPS if capture else ()):
                (tokens16, lp16), ms16 = _timed(device, lambda: _decode(
                    model, batch, opts, head_kernel=1, compute_dtype=torch.bfloat16))
            launches = head_topk.launches - before
            captured["head_topk"] = keep
            forced = _teacher_forced(_bf16(model), batch, tokens16, dryrun._vocab(opts))
            before, keep = fused_attention.launches, {}
            with dryrun_env("OPENVIIC_PALLAS"), _capture(attention_module, "fused_attention",
                                                         keep, (0,) if capture else ()):
                pallas, pallas_ms = _timed(device, lambda: _encoder_out(model, batch))
            captured["fused_attention_tp"] = keep
        res["decode"] = dict(tokens=tokens, logprobs=lp, ms=ms32, bf16_tokens=tokens16,
                             bf16_logprobs=lp16, bf16_ms=ms16, bf16_forced=forced,
                             head_topk_launches=launches,
                             vocab_shard=model.decoder.fc.weight.shape[0], **_moved(mesh))
        res["pallas"] = dict(out=pallas.cpu(), ms=pallas_ms,
                             launches=fused_attention.launches - before,
                             heads=model.encoder.layers[0].mhatt.attention.h)

    mesh = mp.make_mesh({"data": 2, "seq": 2})
    res["seq"] = {}
    for label, family, mode in (("ring", "flagship", "ring"), ("ulysses", "flagship", "ulysses"),
                                ("ort_ring", "ort", "ring")):
        model = _model(opts, device, family)
        calls = (RING_STATS["calls"], ULYSSES_STATS["calls"])
        with ring_attention(mesh, "seq", batch_axis="data", mode=mode):
            y, grads, ms = _forward_backward(model, batch, device)
            calls = (RING_STATS["calls"] - calls[0], ULYSSES_STATS["calls"] - calls[1])
            with torch.no_grad():
                _, fwd_ms = _timed(device, lambda: _encoder_out(model, batch))
        res["seq"][label] = dict(out=y.cpu(), grads={n: g.cpu() for n, g in grads.items()},
                                 ms=ms, forward_ms=fwd_ms, calls=calls)
    res["seq_moved"] = _moved(mesh)

    mesh = mp.make_mesh({"pipe": 3}, [0, 1, 2])
    if mesh.coords is not None:
        model = _model(opts, device)
        features, mask = model.vision_embedding(batch["region_features"])
        features = features.detach()
        encoder = model.encoder
        y, ms = _timed(device, lambda: pipelined_encoder_apply(
            encoder, features, mask, mesh=mesh, microbatches=opts.microbatches))
        (y ** 2).sum().backward()
        first, last = encoder.pipeline_stage
        grads = {}
        for n, p in encoder.named_parameters():
            if n.startswith("layers."):
                parts = n.split(".")
                n = ".".join(["layers", str(first + int(parts[1]))] + parts[2:])
            grads[n] = p.grad.detach().cpu()
        keep: dict = {}
        with torch.no_grad():
            plain, fwd_ms = _timed(device, lambda: pipelined_encoder_apply(
                encoder, features, mask, mesh=mesh, microbatches=opts.microbatches))
            before = fused_attention.launches
            with dryrun_env("OPENVIIC_PALLAS"), _capture(attention_module, "fused_attention",
                                                         keep, (0,) if capture else ()):
                flagged, flag_ms = _timed(device, lambda: pipelined_encoder_apply(
                    encoder, features, mask, mesh=mesh, microbatches=opts.microbatches))
        captured["fused_attention_pipe"] = keep
        res["pipe"] = dict(out=y.detach().cpu(), grads=grads, ms=ms, forward_ms=fwd_ms,
                           plain=plain.cpu(), flagged=flagged.cpu(), flag_ms=flag_ms,
                           flag_launches=fused_attention.launches - before,
                           stage=(first, last), **_moved(mesh))

    mesh = mp.make_mesh({"expert": 4})
    model = _model(opts, device, "moe")
    tensor_parallel.shard_model(model, mesh)
    y, grads, ms = _forward_backward(model, batch, device)
    res["expert"] = dict(out=y.cpu(), ms=ms, experts=model.encoder.layers[0].pwff.w1.shape[0],
                         **_moved(mesh))
    res["expert"]["grads"] = tensor_parallel.full_tensors(grads, model, mesh)
    if capture:
        torch.save({k: v for k, v in captured.items()},
                   os.path.join(opts.capture, "captured.pt"))
    return res


# ------------------------------------------------------------- the families


# the families' decode paths (bf16): name -> (environment flag, beam_search flags)
FAMILY_PATHS = {
    "tuned": (None, dict(head_kernel=1, attn_kernel=True)),  # path (a)
    "resident": (None, dict(head_kernel=1, resident_kernel=True)),  # path (b)
    "fused": ("OPENVIIC_FUSED_STEP", dict(head_kernel=False, beam_resident=False)),  # (c)
    "geo": ("OPENVIIC_GEO_FUSED", dict(head_kernel=1, attn_kernel=True)),
}
# what each kernel path of (h) and (i) launches, a layer and step (geo: a
# layer and request)
PATH_KERNELS = {"tuned": "beam_select_attention", "resident": "resident_layer_step",
                "fused": "fused_layer_step", "geo": "geo_fused_attention"}


def families_of(opts) -> List[str]:
    names = list(FAMILY_NAMES) if opts.family == "all" else opts.family.split(",")
    unknown = [n for n in names if n not in FAMILY_NAMES]
    if unknown:
        raise ValueError(f"unknown families {unknown}; the dry run's are {FAMILY_NAMES}")
    return names


def family_streams(opts, family: str, n: int, seed: int) -> Dict[str, torch.Tensor]:
    """``n`` images of ``family``'s input streams (f32, on the CPU):
    ``--regions`` regions of ``--d-feature`` with a ragged count of zero
    rows; the ORT's boxes in pixels of a 640 x 480 image; DLCT's
    normalized region boxes and a 7 x 7 grid of twice the width with its
    cells' boxes."""
    from openviic_tpu_torch.models.geometry import get_grids_position

    rng = np.random.default_rng(seed)
    r = opts.regions
    feats = rng.normal(size=(n, r, opts.d_feature)).astype(np.float32)
    live = [r - i % 3 for i in range(n)]
    for i in range(n):
        feats[i, live[i]:] = 0.0
    out = {"region_features": feats}
    if family.startswith("ort"):
        x0, y0 = rng.uniform(0, 560, (n, r)), rng.uniform(0, 400, (n, r))
        w, h = rng.uniform(4, 80, (n, r)), rng.uniform(4, 80, (n, r))
        out["region_boxes"] = np.stack([x0, y0, x0 + w, y0 + h], axis=-1).astype(np.float32)
    if family == "dlct":
        lo = rng.uniform(0.0, 0.7, (n, r, 2))
        hi = np.minimum(lo + rng.uniform(0.05, 0.5, (n, r, 2)), 1.0)
        out["region_boxes"] = np.concatenate([lo, hi], axis=-1).astype(np.float32)
        cells = GRID_SIDE * GRID_SIDE
        out["grid_features"] = rng.normal(size=(n, cells, 2 * opts.d_feature)).astype(np.float32)
        out["grid_boxes"] = get_grids_position(n, cells, (GRID_SIDE, GRID_SIDE)).astype(
            np.float32)
    for key in ("region_boxes",):
        if key in out:
            for i in range(n):
                out[key][i, live[i]:] = 0.0
    return {k: torch.from_numpy(v) for k, v in out.items()}


def family_xe_batch(opts, family: str, vocab) -> Dict[str, torch.Tensor]:
    """``--family-batch`` images of ``family``'s streams and ragged captions."""
    batch = family_streams(opts, family, opts.family_batch, seed=11)
    captions = dryrun.global_batch(argparse.Namespace(**dict(
        vars(opts), global_batch=opts.family_batch)), vocab, 0)
    batch.update(caption_tokens=captions["caption_tokens"],
                 shifted_right_caption_tokens=captions["shifted_right_caption_tokens"])
    return batch


def _family_decode(model, streams, opts, device, dtype=None, table=None, **flags):
    from openviic_tpu_torch.decoding import beam_search

    tokens, logprobs = beam_search(model, {k: v.to(device) for k, v in streams.items()},
                                   beam_size=opts.beam, early_exit=False, compute_dtype=dtype,
                                   language_table=table, **flags)
    return tokens.cpu(), logprobs.float().sum(-1).cpu()


def _family_forced(model, streams, tokens, vocab, device) -> torch.Tensor:
    """Each token's log-prob (f32) teacher-forced along ``tokens`` through
    ``model`` (its own dtype), NaN past the first <eos>."""
    dtype = next(model.parameters()).dtype
    tokens = tokens.to(device)
    bos = torch.full_like(tokens[:, :1], vocab.bos_idx)
    batch = {k: v.to(device, dtype) for k, v in streams.items()}
    batch["caption_tokens"] = torch.cat([bos, tokens[:, :-1]], dim=1)
    picked = model(batch).float().gather(-1, tokens[..., None])[..., 0]
    eos = (tokens == vocab.eos_idx).int()
    return picked.masked_fill(torch.cumsum(eos, dim=1) - eos > 0, float("nan")).cpu()


def _family_xe_loss(model, batch, device, mesh=None) -> float:
    """The loss of one f32 XE step from the model's weights, at a learning
    rate of 0 so that the decodes after it read the same weights (on the
    ``mesh`` the sharded step, which shards the model)."""
    from openviic_tpu_torch.parallel import mesh as mp
    from openviic_tpu_torch.training.steps import init_xe_state

    mesh = mesh or mp.make_mesh()
    state = init_xe_state(model, torch.optim.SGD(model.parameters(), lr=0.0), seed=42)
    mp.shard_state(model, state, mesh)
    _, loss = mp.make_sharded_xe_step(model, mesh)(state, {k: v.to(device)
                                                           for k, v in batch.items()})
    model.zero_grad(set_to_none=True)
    return float(loss)


def _family_paths(family: str) -> List[str]:
    return ["tuned"] + (["resident", "fused"] if family == "flagship" else []) + (
        ["geo"] if family == "ort_trig" else [])


def family_references(opts, device):
    """One process's side of (g)-(i), alone on ``device``; and each
    family's bf16 model, for the forced pass along the ranks' captions."""
    vocab = dryrun._vocab(opts)
    out, models = {}, {}
    for family in families_of(opts):
        model = _model(opts, device, family)
        streams = family_streams(opts, family, opts.images, seed=7)
        res = {"xe_loss": _family_xe_loss(model, family_xe_batch(opts, family, vocab), device)}
        with torch.no_grad():
            table = model.compute_language_table()
            small = {k: v[:opts.f32_images] for k, v in streams.items()}
            (res["f32"], res["f32_ms"]) = _timed(device, lambda: _family_decode(
                model, small, opts, device, table=table))
            models[family] = bf16 = _bf16(model)
            table16 = None if table is None else table.to(torch.bfloat16)
            for path in _family_paths(family):
                env, flags = FAMILY_PATHS[path]
                with (dryrun_env(env) if env else contextlib.nullcontext()):
                    res[path], res[f"{path}_ms"] = _timed(device, lambda: _family_decode(
                        bf16, streams, opts, device, table=table16, **flags))
        out[family] = res
        del model
    return out, models


def _family_meshes(opts, mp):
    """Every mesh of the families' run, made in one order on every rank:
    {model 2} over ranks 0-1 and over 2-3, {model 4} over all four."""
    return mp.make_mesh({"model": 2}, [0, 1]), mp.make_mesh({"model": 2}, [2, 3]), \
        mp.make_mesh({"model": 4}, [0, 1, 2, 3])


def _launch_counts():
    from openviic_tpu_torch.ops.beam_select_attention import beam_select_attention
    from openviic_tpu_torch.ops.fused_decoder_step import fused_layer_step
    from openviic_tpu_torch.ops.geo_attention import geo_fused_attention
    from openviic_tpu_torch.ops.head_topk import head_topk
    from openviic_tpu_torch.ops.resident_layer_step import resident_layer_step

    return {fn.__name__: fn.launches for fn in (head_topk, beam_select_attention,
                                                resident_layer_step, fused_layer_step,
                                                geo_fused_attention)}


def _launched(before: dict) -> dict:
    return {k: v - before[k] for k, v in _launch_counts().items()}


def _path_capture(stack, path: str, keep: dict, capture: bool, n_layers: int):
    """Enter a ``_capture`` of the kernel that ``path`` launches: the first
    layer's call at step ``CAPTURE_STEPS[1]`` (geo: its first call)."""
    from openviic_tpu_torch.models import attention as attention_module
    from openviic_tpu_torch.models import decoders as decoders_module

    kernel = PATH_KERNELS[path]
    module = decoders_module if kernel.endswith("layer_step") else attention_module
    calls = (0,) if path == "geo" else (CAPTURE_STEPS[1] * n_layers,)
    stack.enter_context(_capture(module, kernel, keep, calls if capture else ()))


def family_rank_run(opts, out_dir: str) -> dict:
    """One rank's side of (g)-(i) (see the module's docstring)."""
    from openviic_tpu_torch.parallel import mesh as mp
    from openviic_tpu_torch.parallel import runtime, tensor_parallel

    device = torch.device(opts.device)
    rank = runtime.process_index()
    vocab = dryrun._vocab(opts)
    capture = opts.capture is not None and rank == 0
    captured: dict = {}
    pairs = _family_meshes(opts, mp)
    res: dict = {"rank": rank, "families": {}, "paths": {}}
    names = families_of(opts)
    for i, family in enumerate(names):
        mesh = pairs[i % 2]
        if mesh.coords is None:
            continue
        streams = family_streams(opts, family, opts.images, seed=7)
        model = _model(opts, device, family)  # sharded by the XE step's shard_state
        fam = {"xe_loss": _family_xe_loss(model, family_xe_batch(opts, family, vocab), device,
                                          mesh)}
        with torch.no_grad():
            table = model.compute_language_table()
            small = {k: v[:opts.f32_images] for k, v in streams.items()}
            fam["f32"], fam["f32_ms"] = _timed(device, lambda: _family_decode(
                model, small, opts, device, table=table))
            bf16 = _bf16(model)
            table16 = None if table is None else table.to(torch.bfloat16)
            for path in _family_paths(family):
                env, flags = FAMILY_PATHS[path]
                keep: dict = {}
                before = _launch_counts()
                with contextlib.ExitStack() as stack:
                    if env:
                        stack.enter_context(dryrun_env(env))
                    _path_capture(stack, path, keep, capture, opts.layers)
                    fam[path], fam[f"{path}_ms"] = _timed(device, lambda: _family_decode(
                        bf16, streams, opts, device, table=table16, **flags))
                fam[f"{path}_launches"] = _launched(before)
                if keep:
                    captured[f"{family}_{path}"] = keep
                if path == "resident":  # the layers' weights gathered whole, once a decode
                    moved = mesh.moved["model"].get("all_gather", 0)
                    _, fam["gather_ms"] = _timed(device, lambda: [
                        layer.whole_weights(torch.bfloat16) for layer in bf16.decoder.layers])
                    fam["gather_bytes"] = mesh.moved["model"]["all_gather"] - moved
            fam["forced"] = {path: _family_forced(bf16, streams, fam[path][0], vocab, device)
                             for path in _family_paths(family)}
            fam["heads"] = {n: m.h for n, m in model.named_modules()
                            if hasattr(m, "fc_q") and hasattr(m, "d_k")}
        res["families"][family] = fam
    mesh = pairs[2]
    if "flagship" in names:  # path (a) at {model 4}: one head of two a rank
        model = _model(opts, device, "flagship")
        tensor_parallel.shard_model(model, mesh)
        streams = family_streams(opts, "flagship", opts.images, seed=7)
        keep, before = {}, _launch_counts()
        with torch.no_grad(), contextlib.ExitStack() as stack:
            _path_capture(stack, "tuned", keep, capture, opts.layers)
            out, ms = _timed(device, lambda: _family_decode(
                _bf16(model), streams, opts, device, **FAMILY_PATHS["tuned"][1]))
        with torch.no_grad():
            forced = _family_forced(_bf16(model), streams, out[0], vocab, device)
        res["paths"]["tuned_model4"] = dict(decode=out, ms=ms, launches=_launched(before),
                                            heads=model.decoder.layers[0].self_attn.attention.h,
                                            forced=forced)
        if keep:
            captured["flagship_tuned_model4"] = keep
    if capture:
        torch.save(captured, os.path.join(opts.capture, "captured.pt"))
    return res


def family_check(opts, refs: dict, ranks: List[dict]) -> dict:
    """Every rank's (g)-(i) against one process's: the figures, with every
    failure under ``failures``."""
    failures: List[str] = []
    fig: dict = {"families": {}, "paths": {}}
    cuda = torch.device(opts.device).type == "cuda"
    steps = dryrun._vocab(opts).max_caption_length
    names = families_of(opts)
    for i, family in enumerate(names):
        want = refs[family]
        members = [r for r in ranks if family in r["families"]]
        if len(members) != 2:
            failures.append(f"{family}: run on {len(members)} ranks, not 2")
            continue
        row: dict = {}
        for r in members:
            got = r["families"][family]
            gap = abs(got["xe_loss"] - want["xe_loss"]) / abs(want["xe_loss"])
            if gap > LOSS_RTOL:
                failures.append(f"{family} rank {r['rank']}: XE loss gap {gap:.3g}")
            if not torch.equal(got["f32"][0], want["f32"][0]):
                failures.append(f"{family} rank {r['rank']}: f32 tokens differ on "
                                f"{int((got['f32'][0] != want['f32'][0]).any(-1).sum())} images")
            for path in [p for p in PATH_KERNELS if p in got]:
                score_gap = abs(float(got[path][1].mean()) / float(want[path][1].mean()) - 1)
                kernel = PATH_KERNELS[path]
                # RSTNet's decoder turns every kernel flag off, as in JAX
                per = 0 if family == "rstnet" else opts.layers * (1 if path == "geo" else steps)
                launched = got[f"{path}_launches"][kernel]
                if score_gap > SCORE_RTOL or launched != (per if cuda else 0):
                    failures.append(f"{family} {path} rank {r['rank']}: score gap "
                                    f"{score_gap:.3g}, {kernel} launched {launched} times, "
                                    f"{per} expected")
                row.setdefault(path, dict(
                    ms=got[f"{path}_ms"], single_ms=want[f"{path}_ms"], score_gap=score_gap,
                    agreement=float((got[path][0] == want[path][0]).all(-1).float().mean()),
                    launches=got[f"{path}_launches"]))
        got0 = members[0]["families"][family]
        shares, maxima = {}, {}
        for path, forced in got0["forced"].items():
            shares[path], maxima[path] = _forced_bar(forced, want["forced"][path])
            if shares[path] < FORCED_SHARE:
                failures.append(f"{family} {path}: forced log-probs within {FORCED_ATOL} on "
                                f"{shares[path]:.4f}")
        fig["families"][family] = dict(
            ranks=[r["rank"] for r in members], xe_loss=got0["xe_loss"],
            single_xe_loss=want["xe_loss"], f32_ms=got0["f32_ms"], single_f32_ms=want["f32_ms"],
            forced_share=shares, forced_max=maxima, heads=got0["heads"],
            paths=row, **{k: got0[k] for k in ("gather_ms", "gather_bytes") if k in got0})
    if "flagship" in names:
        want = refs["flagship"]["tuned"]
        for r in ranks:
            got = r["paths"]["tuned_model4"]
            score_gap = abs(float(got["decode"][1].mean()) / float(want[1].mean()) - 1)
            launched = got["launches"]["beam_select_attention"]
            if score_gap > SCORE_RTOL or launched != (opts.layers * steps if cuda else 0):
                failures.append(f"tuned at model 4 rank {r['rank']}: score gap {score_gap:.3g}, "
                                f"beam_select_attention launched {launched} times")
        got = ranks[0]["paths"]["tuned_model4"]
        share, gap = _forced_bar(got["forced"], refs["flagship"]["forced"]["tuned_model4"])
        if share < FORCED_SHARE:
            failures.append(f"tuned at model 4: forced log-probs within {FORCED_ATOL} on "
                            f"{share:.4f}")
        fig["paths"]["tuned_model4"] = dict(
            ms=got["ms"], single_ms=refs["flagship"]["tuned_ms"], heads=got["heads"],
            launches=got["launches"], forced_share=share, forced_max=gap,
            agreement=float((got["decode"][0] == want[0]).all(-1).float().mean()))
    fig["failures"] = failures
    return fig


def _forced_bar(got: torch.Tensor, want: torch.Tensor):
    """The share of the live tokens whose forced log-probs are within
    ``FORCED_ATOL``, and the largest gap."""
    gap = (got - want)[~torch.isnan(got)].abs()
    return float((gap <= FORCED_ATOL).float().mean()), float(gap.max())


def families_run(opts, out_dir: str) -> dict:
    """(g)-(i): one process's references, the four ranks, the checks."""
    device = torch.device(opts.device)
    t0 = time.perf_counter()
    refs, models = family_references(opts, device)
    refs_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    procs = dryrun.start(["-m", "openviic_tpu_torch.parallel.layouts_dryrun",
                          *_worker_argv(opts, out_dir)], NPROCS, out_dir)
    dryrun.wait(procs, out_dir, opts.timeout)
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
             for r in range(NPROCS)]
    ranks_s = time.perf_counter() - t0
    vocab = dryrun._vocab(opts)
    with torch.no_grad():  # one process along each path's bf16 captions on the ranks
        for family, want in refs.items():
            first = next(r for r in ranks if family in r["families"])["families"][family]
            model, streams = models.pop(family), family_streams(opts, family, opts.images, 7)
            want["forced"] = {path: _family_forced(model, streams, first[path][0], vocab, device)
                              for path in _family_paths(family)}
            if family == "flagship":
                want["forced"]["tuned_model4"] = _family_forced(
                    model, streams, ranks[0]["paths"]["tuned_model4"]["decode"][0], vocab,
                    device)
            del model
    fig = family_check(opts, refs, ranks)
    fig.update(references_s=refs_s, ranks_s=ranks_s)
    return fig


# ------------------------------------------------------------- checks


def _gap(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max())


def _grads_close(got: dict, want: dict, atol: float, rtol: float = 0.0) -> List[str]:
    """The leaves whose gap exceeds ``atol`` times the largest gradient of
    any leaf (the scale of this run's gradients) plus ``rtol`` of each
    element."""
    scale = max(float(ref.abs().max()) for ref in want.values())
    bad = []
    for name, ref in want.items():
        g = got.get(name)
        if g is None:
            bad.append(f"{name} missing")
        elif bool(((g - ref).abs() > atol * scale + rtol * ref.abs()).any()):
            bad.append(f"{name} ({_gap(g, ref):.3g} against {scale:.3g})")
    return bad


def check(opts, refs: dict, ranks: List[dict]) -> dict:
    """Every rank's cases against one process's: the figures, with every
    failure under ``failures``."""
    failures: List[str] = []
    fig: dict = {"xe": {}}
    cuda = torch.device(opts.device).type == "cuda"  # the kernels launch on a card only
    for name, axes, members, optimizer_name in XE_CASES:
        want = refs["xe"][name]
        for r in (ranks[i] for i in members):
            got = r["xe"][name]
            gap = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))
            if gap > LOSS_RTOL:
                failures.append(f"xe {name} rank {r['rank']}: loss gap {gap:.3g}")
            if got["params"] is not None:
                for n, p in want["params"].items():
                    if not torch.allclose(got["params"][n], p, rtol=PARAM_RTOL, atol=PARAM_ATOL):
                        failures.append(f"xe {name} rank {r['rank']}: {n} off by "
                                        f"{_gap(got['params'][n], p):.3g}")
            if 2 * got["sharded_bytes"] != want["sharded_bytes"]:
                failures.append(f"xe {name} rank {r['rank']}: {got['sharded_bytes']} sharded "
                                f"bytes, one process {want['sharded_bytes']}")
        r0 = ranks[members[0]]["xe"][name]
        fig["xe"][name] = dict(axes=axes, optimizer=optimizer_name,
                               ms=_median(r0["ms"][1:]), single_ms=_median(want["ms"][1:]),
                               loss_gap=max(abs(a - b) / abs(b) for a, b in
                                            zip(r0["losses"], want["losses"])),
                               sharded_bytes=r0["sharded_bytes"],
                               single_sharded_bytes=want["sharded_bytes"],
                               moved=r0["moved"], grad_allreduce_bytes=r0["grad_allreduce_bytes"],
                               staged=r0["staged"])
    tokens, lp = refs["decode_f32"]
    tokens16, lp16 = refs["decode_bf16"]
    steps = dryrun._vocab(opts).max_caption_length
    for r in ranks[:2]:
        d = r["decode"]
        if not torch.equal(d["tokens"], tokens):
            failures.append(f"decode rank {r['rank']}: f32 tokens differ on "
                            f"{int((d['tokens'] != tokens).any(-1).sum())} images")
        if d["head_topk_launches"] != (steps if cuda else 0):
            failures.append(f"decode rank {r['rank']}: head_topk launched "
                            f"{d['head_topk_launches']} times in {steps} steps")
        p = r["pallas"]
        if (p["launches"] != (opts.layers if cuda else 0)
                or _gap(p["out"], refs["pallas"]) > KERNEL_ATOL):
            failures.append(f"pallas rank {r['rank']}: {p['launches']} launches, gap "
                            f"{_gap(p['out'], refs['pallas']):.3g}")
    d = ranks[0]["decode"]
    agree = float((d["bf16_tokens"] == tokens16).all(-1).float().mean())
    witness = float((refs["decode_bf16_witness"][0] == tokens16).all(-1).float().mean())
    score_gap = abs(float(d["bf16_logprobs"].mean()) / float(lp16.mean()) - 1)
    live = ~torch.isnan(d["bf16_forced"])
    forced_gap = (d["bf16_forced"] - refs["forced"])[live].abs()
    forced_share = float((forced_gap <= FORCED_ATOL).float().mean())
    if score_gap > SCORE_RTOL or forced_share < FORCED_SHARE:
        failures.append(f"bf16 head-kernel decode: score gap {score_gap:.3g}, forced log-probs "
                        f"within {FORCED_ATOL} on {forced_share:.4f}")
    fig["decode"] = dict(f32_ms=d["ms"], bf16_ms=d["bf16_ms"],
                         single_f32_ms=refs["decode_f32_ms"],
                         single_bf16_ms=refs["decode_bf16_ms"], agreement=agree,
                         witness_agreement=witness, score_gap=score_gap,
                         forced_share=forced_share, forced_max=float(forced_gap.max()),
                         forced_tokens=int(live.sum()),
                         head_topk_launches=d["head_topk_launches"],
                         vocab_shard=d["vocab_shard"], moved=d["moved"], staged=d["staged"])
    fig["pallas"] = {k: ranks[0]["pallas"][k] for k in ("ms", "launches", "heads")}
    fig["pallas"]["gap"] = max(_gap(r["pallas"]["out"], refs["pallas"]) for r in ranks[:2])
    fig["seq"] = {}
    for label, family, calls in (("ring", "flagship", (opts.layers, 0)),
                                 ("ulysses", "flagship", (0, opts.layers)),
                                 ("ort_ring", "ort", (opts.layers, 0))):
        want = refs[family]
        for r in ranks:
            got = r["seq"][label]
            gap = _gap(got["out"], want["out"])
            bad = _grads_close(got["grads"], want["grads"], ENCODER_GRAD)
            if gap > ENCODER_ATOL or bad or got["calls"] != calls:
                failures.append(f"{label} rank {r['rank']}: gap {gap:.3g}, calls {got['calls']},"
                                f" gradients {bad[:3]}")
        fig["seq"][label] = dict(ms=ranks[0]["seq"][label]["ms"],
                                 forward_ms=ranks[0]["seq"][label]["forward_ms"],
                                 single_ms=want["ms"], calls=ranks[0]["seq"][label]["calls"],
                                 gap=max(_gap(r["seq"][label]["out"], want["out"])
                                         for r in ranks))
    fig["seq"]["moved"] = ranks[0]["seq_moved"]
    want = refs["pipe"]
    for r in ranks[:3]:
        p = r["pipe"]
        gap = _gap(p["out"], want["out"])
        bad = _grads_close(p["grads"], {n: g for n, g in want["grads"].items() if n in p["grads"]},
                           PIPE_GRAD_ATOL, PIPE_GRAD_RTOL)
        flag_gap = _gap(p["flagged"], p["plain"])
        if (gap > PIPE_ATOL or bad or p["flag_launches"] != (opts.microbatches if cuda else 0)
                or flag_gap > KERNEL_ATOL or _gap(p["plain"], want["out"]) > PIPE_ATOL):
            failures.append(f"pipe rank {r['rank']}: gap {gap:.3g}, gradients {bad[:3]}, "
                            f"{p['flag_launches']} flagged launches, flag gap {flag_gap:.3g}")
    covered = set().union(*(r["pipe"]["grads"] for r in ranks[:3]))
    if covered != set(want["grads"]):
        failures.append(f"pipe: gradients of {sorted(set(want['grads']) - covered)} missing")
    p0 = ranks[0]["pipe"]
    fig["pipe"] = dict(ms=p0["ms"], forward_ms=p0["forward_ms"], flag_ms=p0["flag_ms"],
                       flag_launches=p0["flag_launches"],
                       bubble=(3 - 1) / (opts.microbatches + 3 - 1), moved=p0["moved"],
                       staged=p0["staged"])
    want = refs["moe"]
    for r in ranks:
        e = r["expert"]
        gap = _gap(e["out"], want["out"])
        bad = _grads_close(e["grads"], want["grads"], PIPE_GRAD_ATOL, PIPE_GRAD_RTOL)
        if gap > PIPE_ATOL or bad or e["experts"] != opts.experts // 4:
            failures.append(f"expert rank {r['rank']}: gap {gap:.3g}, gradients {bad[:3]}")
    e0 = ranks[0]["expert"]
    fig["expert"] = dict(ms=e0["ms"], single_ms=want["ms"], moved=e0["moved"],
                         staged=e0["staged"], gap=max(_gap(r["expert"]["out"], want["out"])
                                                      for r in ranks))
    fig["failures"] = failures
    return fig


def _median(xs) -> float:
    return float(np.median(xs)) if len(xs) else float("nan")


def _worker_argv(opts, out_dir: str) -> List[str]:
    argv = []
    for key, value in vars(opts).items():
        if key in ("worker", "out") or value is None or value is False:
            continue
        argv += ["--" + key.replace("_", "-"), str(value)]
    return argv + ["--worker", "--out", out_dir]


def run(opts) -> dict:
    """The dry run (see the module's docstring); returns its figures."""
    out_dir = opts.out or tempfile.mkdtemp(prefix="openviic_layouts_")
    os.makedirs(out_dir, exist_ok=True)
    threads = torch.get_num_threads()
    try:
        if opts.threads:
            torch.set_num_threads(opts.threads)
        device = torch.device(opts.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"layouts dryrun: --device {opts.device} and no CUDA device")
        if opts.family:
            fig = families_run(opts, out_dir)
            failures = fig.pop("failures")
            if failures:
                raise AssertionError(f"{'; '.join(failures)} (figures: {json.dumps(fig)})")
            return fig
        t0 = time.perf_counter()
        refs = references(opts, device)
        refs_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        procs = dryrun.start(["-m", "openviic_tpu_torch.parallel.layouts_dryrun",
                              *_worker_argv(opts, out_dir)], NPROCS, out_dir)
        dryrun.wait(procs, out_dir, opts.timeout)
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                 for r in range(NPROCS)]
        with torch.no_grad():  # one process along the ranks' bf16 captions
            refs["forced"] = _teacher_forced(_bf16(_model(opts, device)), images(opts, device),
                                             ranks[0]["decode"]["bf16_tokens"],
                                             dryrun._vocab(opts))
        fig = check(opts, refs, ranks)
        fig.update(backend=opts.backend, device=opts.device, nprocs=NPROCS,
                   references_s=refs_s, ranks_s=time.perf_counter() - t0)
        failures = fig.pop("failures")
        if failures:
            raise AssertionError(f"{'; '.join(failures)} (figures: {json.dumps(fig)})")
        return fig
    finally:
        torch.set_num_threads(threads)
        if opts.out is None:
            shutil.rmtree(out_dir, ignore_errors=True)


def single_rank(opts) -> dict:
    """One rank over ``--backend`` in this process (a group on a file store),
    every axis of size 1: the tensor-parallel XE step and decode, the ring,
    Ulysses, the pipeline and the MoE at meshes of one rank, each bit-equal
    to the same call without a process group.  Returns what was compared."""
    from openviic_tpu_torch.parallel import mesh as mp
    from openviic_tpu_torch.parallel import runtime, tensor_parallel
    from openviic_tpu_torch.parallel.pipeline import pipelined_encoder_apply
    from openviic_tpu_torch.parallel.ring_attention import ring_attention

    device = torch.device(opts.device)
    opts.images = min(opts.images, 4)
    batch = images(opts, device)

    def cases(mesh_of):
        out = {}
        losses, _, model, _ = _xe_run(opts, device, mesh_of({"data": 1, "model": 1}), "sgd")
        out["xe"] = losses
        model = _model(opts, device)
        tensor_parallel.shard_model(model, mesh_of({"model": 1, "expert": 1}))
        with torch.no_grad():
            out["decode"] = _decode(model, batch, opts)
            for mode in ("ring", "ulysses"):
                with ring_attention(mesh_of({"data": 1, "seq": 1}), batch_axis="data",
                                    mode=mode):
                    out[mode] = _encoder_out(model, batch)
            features, mask = model.vision_embedding(batch["region_features"])
            out["pipe"] = pipelined_encoder_apply(model.encoder, features, mask,
                                                  mesh=mesh_of({"pipe": 1}), microbatches=2)
            moe = _model(opts, device, "moe")
            tensor_parallel.shard_model(moe, mesh_of({"expert": 1}))
            out["moe"] = _encoder_out(moe, batch)
        return out

    alone = cases(lambda axes: mp.Mesh(axes, [0], 0, {}, {}))
    out_dir = tempfile.mkdtemp(prefix="openviic_layouts_one_")
    try:
        runtime.initialize_distributed(device, backend=opts.backend,
                                       init_method="file://" + os.path.join(out_dir, "group"),
                                       world_size=1, rank=0)
        try:
            grouped = cases(lambda axes: mp.make_mesh(axes))
        finally:
            runtime.shutdown()
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    differ = [k for k in alone if not _equal(alone[k], grouped[k])]
    if differ:
        raise AssertionError(f"one {opts.backend} rank differs from no group in {differ}")
    return {"backend": opts.backend, "bit_equal": sorted(alone)}


def _equal(a, b) -> bool:
    if isinstance(a, (tuple, list)):
        return all(_equal(x, y) for x, y in zip(a, b))
    if torch.is_tensor(a):
        return torch.equal(a, b)
    return a == b


def main(argv: Optional[List[str]] = None) -> int:
    opts = parse(argv)
    device = torch.device(opts.device)
    if device.type == "cuda":  # f32 products in full f32, as one process's
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if opts.threads:
        torch.set_num_threads(opts.threads)
    if opts.worker:
        from openviic_tpu_torch.parallel import runtime

        runtime.initialize_distributed(device, backend=opts.backend)
        try:
            result = (family_rank_run if opts.family else rank_run)(opts, opts.out)
        finally:
            runtime.shutdown()
        torch.save(result, os.path.join(opts.out, f"rank{result['rank']}.pt"))
        return 0
    print(json.dumps(run(opts)), flush=True)
    print("layouts dryrun ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
