"""Batched beam search, beam-resident (counterpart of
``openviic_tpu/decoding/beam_search.py::beam_search`` with
``beam_resident=True``).

The decode is a Python loop over steps.  Beam-resident mode never reorders
the KV caches: each beam writes its own slot, and an ancestry table
``(bs, beam, L)`` says which slot holds position t' of each current beam's
prefix; beam selection gathers only that table and the small per-beam
state.  Cross-attention K/V stay at image granularity.

Selection follows the JAX package exactly:

 - the reference's ``-999`` continuation for finished beams (word 0 at the
   frozen sequence log-prob, every other word at -999, zero per-step word
   log-prob), substituted analytically;
 - the t=0 special case through a -1e18 initial log-prob on every beam but
   beam 0;
 - per-beam exact top-k, then an exact top-k over the beam*k survivors, all
   with the flattened argsort's tie order (beam-major, lowest word id
   first).  ``torch.topk`` promises no tie order, so ties are resolved by
   stable sorts and first-index argmaxes;
 - ``early_exit``: stop once every beam of every image has emitted <eos>
   (at t >= 2), which changes no observable output.

Two selection branches: fast select (the decoder returns raw logits and
their logsumexp; ``_select_topk_hier``) and the head kernel (the decoder
returns its pre-head hidden state and ``ops.head_topk`` computes head, lse
and per-row top-k in one kernel).  Selection math is float32 whatever the
compute dtype.  The default non-resident path and ``return_probs`` are not
ported."""

from __future__ import annotations

import copy
from typing import Dict, Optional

import torch

from openviic_tpu_torch.models.base import make_decode_cache
from openviic_tpu_torch.ops.head_topk import head_topk


def _topk_lowest_index(x: torch.Tensor, k: int):
    """Top-k along the last axis; equal values keep ascending index order."""
    vals, idxs = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idxs[..., :k]


def _gather_beams(x: torch.Tensor, selected_beam: torch.Tensor) -> torch.Tensor:
    """Beam-axis gather of a small (bs, beam, ...) tensor: out[b, j] =
    x[b, selected_beam[b, j]] (an index gather, exact for every dtype)."""
    idx = selected_beam.reshape(selected_beam.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand((-1, -1) + tuple(x.shape[2:])))


def _select_topk_hier(logits, offset, finished, seq_logprob, beam_size: int,
                      tile: int = 512):
    """Exact per-beam top-k with one full pass over the vocab: tile maxima,
    then k rounds that touch only the winning tile.  Then
    ``_finish_select``.

    logits (bs, beam, V) f32 raw head outputs; offset (bs, beam) =
    seq_logprob - logsumexp; finished (bs, beam) bool."""
    b_s, n_beams, V = logits.shape
    n_tiles = -(-V // tile)
    pad = n_tiles * tile - V
    if pad:
        logits = torch.nn.functional.pad(logits, (0, pad), value=float("-inf"))
    tiles = logits.reshape(b_s, n_beams, n_tiles, tile)
    tmax = tiles.amax(dim=-1)  # (bs, beam, n_tiles): the one full pass

    col = torch.arange(tile, device=logits.device)
    tcol = torch.arange(n_tiles, device=logits.device)
    neg_inf = torch.tensor(float("-inf"), device=logits.device)
    picked = []
    for _ in range(beam_size):
        jt = tmax.argmax(dim=-1)  # winning tile, first on ties
        idx = jt[..., None, None].expand(b_s, n_beams, 1, tile)
        t_sel = torch.gather(tiles, 2, idx)[..., 0, :]
        for p_jt, p_jw, _ in picked:  # re-mask words already extracted
            hit = (jt == p_jt)[..., None] & (col == p_jw[..., None])
            t_sel = torch.where(hit, neg_inf, t_sel)
        jw = t_sel.argmax(dim=-1)  # first on ties
        val = torch.gather(t_sel, -1, jw[..., None])[..., 0]
        picked.append((jt, jw, val))
        # refresh the winning tile's max with the chosen word removed
        t_rem = torch.where(col == jw[..., None], neg_inf, t_sel)
        tmax = torch.where(tcol == jt[..., None], t_rem.amax(dim=-1)[..., None], tmax)

    s1_words = torch.stack([jt * tile + jw for jt, jw, _ in picked], dim=-1)
    s1_logit = torch.stack([v for _, _, v in picked], dim=-1)
    return _finish_select(s1_logit, s1_words, offset, finished, seq_logprob, beam_size)


def _finish_select(s1_logit, s1_words, offset, finished, seq_logprob, beam_size: int):
    """Finished-beam substitution + exact top-k over the beam*k per-beam
    candidates (s1_logit/s1_words: (bs, beam, k) raw logits + word ids).

    Returns (selected_logprob, selected_beam, selected_words,
    selected_logit), each (bs, beam)."""
    b_s, n_beams = s1_logit.shape[:2]
    s1_vals = s1_logit + offset[..., None]

    # finished beams: candidate 0 is word 0 at the frozen seq log-prob, every
    # other word sits at exactly -999 (the reference's continuation trick)
    first = seq_logprob >= -999.0
    minus = torch.full_like(s1_vals, -999.0)
    fin_vals = torch.where(
        first[..., None],
        torch.cat([seq_logprob[..., None], minus[..., 1:]], dim=-1),
        minus,
    )
    ar = torch.arange(beam_size, device=s1_words.device)
    fin_words = torch.where(first[..., None], ar, ar + 1)
    fin = finished[..., None]
    s1_vals = torch.where(fin, fin_vals, s1_vals)
    s1_words = torch.where(fin, fin_words, s1_words)
    s1_logit = torch.where(fin, torch.zeros_like(s1_logit), s1_logit)

    flat_vals = s1_vals.reshape(b_s, n_beams * beam_size)
    sel_v, sel_i = _topk_lowest_index(flat_vals, beam_size)
    selected_beam = torch.div(sel_i, beam_size, rounding_mode="floor")
    selected_words = torch.gather(s1_words.reshape(b_s, -1), 1, sel_i)
    selected_logit = torch.gather(s1_logit.reshape(b_s, -1), 1, sel_i)
    return sel_v, selected_beam, selected_words, selected_logit


def _supports_beam_resident(model) -> bool:
    """Beam-resident decode needs plain SDPA attention in the decoder."""
    dec = model.config.DECODER
    att = dec.ATTENTION
    return (
        dec.ARCHITECTURE == "Decoder"
        and att.SELF_ATTENTION.ARCHITECTURE == "ScaledDotProductAttention"
        and att.ENC_ATTENTION.ARCHITECTURE == "ScaledDotProductAttention"
    )


@torch.no_grad()
def _beam_search(model, batch: Dict[str, torch.Tensor], beam_size: int,
                 out_size: int, early_exit: bool, compute_dtype, head_kernel: bool):
    """``beam_search`` that also returns the number of decode steps run."""
    if not _supports_beam_resident(model):
        raise NotImplementedError(
            "only the beam-resident decode of SDPA decoders is ported"
        )
    if not 1 <= out_size <= beam_size:
        raise ValueError(f"out_size {out_size} must lie in [1, beam_size={beam_size}]")
    param = next(model.parameters())
    device, dtype = param.device, param.dtype
    if compute_dtype is not None and compute_dtype != dtype:
        # the network runs in compute_dtype; the caller's model is left as is
        model = copy.deepcopy(model).to(compute_dtype)
        dtype = compute_dtype
    batch = {
        key: value.to(device=device, dtype=dtype if value.is_floating_point() else None)
        for key, value in batch.items()
    }

    vocab = model.vocab
    max_len = vocab.max_caption_length
    eos_idx, bos_idx = vocab.eos_idx, vocab.bos_idx
    vocab_size = len(vocab)

    # 1) encode once at batch size; cross K/V stay at image granularity
    memory, memory_mask = model.encoder_forward(batch)
    b_s = memory.shape[0]
    n_rows = b_s * beam_size
    cache = make_decode_cache(model.config.DECODER, vocab, n_rows, dtype=dtype, device=device)
    cache = model.prepare_cache(cache, memory)

    f32 = dict(dtype=torch.float32, device=device)
    seq_logprob = torch.full((b_s, beam_size), -1e18, **f32)
    seq_logprob[:, 0] = 0.0
    seq_mask = torch.ones((b_s, beam_size), **f32)
    selected_words = torch.full((n_rows, 1), bos_idx, dtype=torch.long, device=device)
    outputs = torch.zeros((b_s, beam_size, max_len), dtype=torch.long, device=device)
    log_probs = torch.zeros((b_s, beam_size, max_len), **f32)
    ancestry = torch.zeros((b_s, beam_size, max_len), dtype=torch.long, device=device)
    own_slot = torch.arange(beam_size, device=device)[None, :]
    head_weight = model.decoder.fc.weight

    steps = 0
    for t in range(max_len):
        if early_exit and t >= 2 and not bool((seq_mask > 0).any()):
            break
        # position t of every current beam lives at its own slot
        ancestry[:, :, t] = own_slot
        head, cache = model.decode_step(
            t, selected_words, cache, memory_mask, ancestry=ancestry,
            beam_select=beam_size, raw_head="hidden" if head_kernel else True,
        )
        prev_words = selected_words.reshape(b_s, beam_size)
        if t > 0:
            seq_mask = seq_mask * (prev_words != eos_idx).float()
            finished = seq_mask == 0.0
        else:
            finished = torch.zeros((b_s, beam_size), dtype=torch.bool, device=device)
        if head_kernel:
            vals, idxs, lse_rows = head_topk(
                head.to(torch.bfloat16).contiguous(),
                head_weight.to(torch.bfloat16).contiguous(),
                beam_size,
            )
            lse = lse_rows.reshape(b_s, beam_size)
            selected = _finish_select(
                vals.reshape(b_s, beam_size, beam_size),
                idxs.long().reshape(b_s, beam_size, beam_size),
                seq_logprob - lse, finished, seq_logprob, beam_size,
            )
        else:
            logits, lse = head
            lse = lse.reshape(b_s, beam_size)
            selected = _select_topk_hier(
                logits.reshape(b_s, beam_size, vocab_size), seq_logprob - lse,
                finished, seq_logprob, beam_size,
            )
        selected_logprob, selected_beam, words, selected_logit = selected
        lse_sel = _gather_beams(lse, selected_beam)
        fin_sel = _gather_beams(finished, selected_beam)
        this_word_logprob = torch.where(
            fin_sel, torch.zeros_like(lse_sel), selected_logit - lse_sel
        )

        # reorder the small per-beam state; the caches stay put
        ancestry = _gather_beams(ancestry, selected_beam)
        seq_mask = _gather_beams(seq_mask, selected_beam)
        outputs = _gather_beams(outputs, selected_beam)
        outputs[:, :, t] = words
        log_probs = _gather_beams(log_probs, selected_beam)
        log_probs[:, :, t] = this_word_logprob
        seq_logprob = selected_logprob
        selected_words = words.reshape(n_rows, 1)
        steps += 1

    # sort beams by final sequence log-prob (stable: ties keep beam order)
    sort_idxs = torch.argsort(-seq_logprob, dim=1, stable=True)
    outputs = _gather_beams(outputs, sort_idxs)[:, :out_size]
    log_probs = _gather_beams(log_probs, sort_idxs)[:, :out_size]
    if out_size == 1:
        outputs, log_probs = outputs[:, 0], log_probs[:, 0]
    return outputs, log_probs, steps


def beam_search(model, batch: Dict[str, torch.Tensor], beam_size: int,
                out_size: int = 1, early_exit: bool = True,
                compute_dtype: Optional[torch.dtype] = None,
                head_kernel: bool = False):
    """Run batched beam-resident beam search; returns (outputs, log_probs).

    outputs: (bs, out_size, max_len) int64 token ids, log_probs: the
    per-step word log-probs (f32) likewise, both squeezed to (bs, max_len)
    when ``out_size == 1``.  ``batch`` holds the model's input features;
    they move to the model's device.  ``compute_dtype`` (e.g.
    ``torch.bfloat16``) runs the network in that dtype (a converted copy if
    the model holds another); selection stays f32.  ``head_kernel`` selects
    through the fused head + lse + top-k kernel (ops/head_topk.py), which
    runs its plain version on the CPU and the CUDA kernel on a card."""
    outputs, log_probs, _ = _beam_search(
        model, batch, beam_size, out_size, early_exit, compute_dtype, head_kernel
    )
    return outputs, log_probs


class BeamSearcher:
    """Decode callable for one model and decode configuration; keeps the
    count of decode steps it has run (``steps``), one head-kernel launch
    each when ``head_kernel`` is on a CUDA model."""

    def __init__(self, model, compute_dtype=None, head_kernel: bool = False):
        self.model = model
        self.compute_dtype = compute_dtype
        self.head_kernel = bool(head_kernel)
        self.steps = 0

    def __call__(self, batch, beam_size: int, out_size: int = 1):
        outputs, log_probs, steps = _beam_search(
            self.model, batch, beam_size, out_size, True,
            self.compute_dtype, self.head_kernel,
        )
        self.steps += steps
        return outputs, log_probs
