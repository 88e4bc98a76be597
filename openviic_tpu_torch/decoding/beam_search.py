"""Batched beam search (counterpart of
``openviic_tpu/decoding/beam_search.py::beam_search``), beam-resident or
not.

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

Three selection branches: fast select (the decoder returns raw logits and
their logsumexp; ``_select_topk_hier``), the head kernel (the decoder
returns its pre-head hidden state and ``ops.head_topk`` computes head, lse
and per-row top-k in one kernel), and, on the non-resident path (the JAX
default), full log-softmax distributions through ``_select_topk`` with the
caches reordered physically every step.  Selection math is float32
whatever the compute dtype.

A tensor-parallel model (``parallel.tensor_parallel.shard_model`` over a
``model`` axis) keeps its heads' share of the caches, and fast selection
takes each rank's top-k and logsumexp over its vocab shard (the head
kernel on the shard with ``head_kernel``), merged exactly across the ranks
(``vocab_parallel_topk``).  Every decode flag runs there, as in the JAX
package under GSPMD: ``attn_kernel`` on the rank's heads, and a layer
whose steps run a whole-layer kernel (``resident_kernel``,
``OPENVIIC_FUSED_STEP=1``) keeps every head in its caches and runs the
kernel whole on every rank from its weights gathered once
(``models/decoders.py``).

Dropout-active sampling (SCST's ``TRAINING.SCST_SAMPLE_DROPOUT``, the JAX
``train_dropout_rng``) runs the encoder and every step in train mode, each
on a stream of its own derived from one seed; the whole-layer step kernels
bypass themselves there, as in the JAX package.  Otherwise the decode runs
in eval mode whatever the model's mode.

RSTNet's ``AdaptiveDecoder`` decodes off the beam-resident path, as in the
JAX package: its attentions take language signals, so every kernel flag
turns off and the non-resident path runs.  ``language_table`` (its
``compute_language_table``) replaces the language model of every step by
a row gather; it is cast to the decode's dtype with the rest of the
cache.

Each batch's decode is a ``_Stream`` (encoder and cache, then one
``step`` a position, then ``finish``); ``beam_search`` runs one, and
``beam_search_multi`` several in one interleaved loop."""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Tuple

import torch

from openviic_tpu_torch import rng
from openviic_tpu_torch.models.base import make_decode_cache
from openviic_tpu_torch.ops.head_topk import head_topk
from openviic_tpu_torch.parallel.tensor_parallel import vocab_parallel_topk


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


def _select_topk(candidate_logprob, beam_size: int):
    """Top beam_size over the flattened (beam, vocab) candidates of the
    non-resident path (JAX ``_select_topk``): per-beam iterative argmax
    (first index on ties), then an exact top-k over the beam*k survivors
    with the flattened argsort's tie order.  Returns (selected_logprob,
    selected_beam, selected_words), each (bs, beam)."""
    b_s, n_beams, vocab_size = candidate_logprob.shape
    vals = candidate_logprob
    col = torch.arange(vocab_size, device=vals.device)
    s1_vals, s1_idx = [], []
    for _ in range(beam_size):
        j = vals.argmax(dim=-1)  # first index on ties
        s1_vals.append(torch.gather(vals, -1, j[..., None])[..., 0])
        s1_idx.append(j)
        vals = torch.where(col == j[..., None], float("-inf"), vals)
    s1_vals = torch.stack(s1_vals, dim=-1).reshape(b_s, n_beams * beam_size)
    s1_idx = torch.stack(s1_idx, dim=-1).reshape(b_s, n_beams * beam_size)
    sel_v, sel_i = _topk_lowest_index(s1_vals, beam_size)
    selected_beam = torch.div(sel_i, beam_size, rounding_mode="floor")
    return sel_v, selected_beam, torch.gather(s1_idx, 1, sel_i)


def _expand_to_beams(x: torch.Tensor, beam_size: int) -> torch.Tensor:
    """(bs, ...) -> (bs*beam, ...) by repeating each row beam_size times."""
    return x.repeat_interleave(beam_size, dim=0)


def _reorder_rows(x: torch.Tensor, selected_beam: torch.Tensor) -> torch.Tensor:
    """Physical beam reorder of a (bs*beam, ...) decode-state tensor:
    row (b, j) takes row (b, selected_beam[b, j]) (an index gather)."""
    b_s, n_beams = selected_beam.shape
    rows = torch.arange(b_s, device=x.device)[:, None] * n_beams + selected_beam
    return x.index_select(0, rows.reshape(-1))


def _reorder_cache(cache, selected_beam):
    """Reorder every self-attention K/V and the pad mask (JAX
    ``_gather_beams`` over the dynamic cache); the cross K/V are the same
    for every beam of an image and stay put."""
    for layer in cache["layers"]:
        layer["self"] = {k: _reorder_rows(v, selected_beam) for k, v in layer["self"].items()}
    cache["pad"] = _reorder_rows(cache["pad"], selected_beam)
    return cache


def _supports_beam_resident(model) -> bool:
    """Beam-resident decode needs plain SDPA attention in a ``Decoder`` or
    ``MeshedDecoder`` (the JAX gate)."""
    dec = model.config.DECODER
    att = dec.ATTENTION
    return (
        dec.ARCHITECTURE in ("Decoder", "MeshedDecoder")
        and att.SELF_ATTENTION.ARCHITECTURE == "ScaledDotProductAttention"
        and att.ENC_ATTENTION.ARCHITECTURE == "ScaledDotProductAttention"
    )


class ComputeShadow:
    """A model's copy in a compute dtype (e.g. bf16) for decoding, kept in
    step with the master.

    Calling it with the master returns the copy, refreshed in place
    (``copy_`` of every parameter and buffer) only when a master tensor
    changed since the last call, by ``(data_ptr, _version)``: an optimizer
    step or ``load_state_dict`` bumps the version counter, so sampling after
    an update never reads the old weights.  An update that bypasses the
    counter (``torch.optim``'s ``fused=True`` kernels) is not seen.  The
    copy is rebuilt when the master is replaced, moved or reshaped; it
    shares the master's vocab and config objects.  ``casts`` counts the
    rebuilds and refreshes.  The copy's fused weight pack
    (``DecoderLayer.fused_weights``) follows its parameters."""

    def __init__(self, dtype: torch.dtype):
        self.dtype = dtype
        self.model = None
        self.casts = 0
        self._master = None
        self._key = None

    def __call__(self, master: torch.nn.Module) -> torch.nn.Module:
        tensors = [*master.parameters(), *master.buffers()]
        key = tuple((t.device, t.data_ptr(), t._version) for t in tensors)
        if self._master is master and key == self._key:
            return self.model
        copies = ([*self.model.parameters(), *self.model.buffers()]
                  if self._master is master else [])
        if len(copies) == len(tensors) and all(
                c.device == t.device and c.shape == t.shape for c, t in zip(copies, tensors)):
            with torch.no_grad():
                for c, t in zip(copies, tensors):
                    c.copy_(t)
        else:
            shared = {id(v): v for m in master.modules() for k, v in vars(m).items()
                      if k in ("vocab", "config")}
            model = copy.deepcopy(master, shared)
            for p in model.parameters():
                p.grad = None
            self.model = model.to(self.dtype).requires_grad_(False)
        self._master, self._key = master, key
        self.casts += 1
        return self.model


def _running_model(model, compute_dtype, shadow: Optional[ComputeShadow]):
    """The model the decode runs: ``model`` itself when it holds the
    compute dtype, else its shadow in that dtype (a one-off copy without a
    ``shadow`` to keep)."""
    dtype = next(model.parameters()).dtype
    if compute_dtype is None or compute_dtype == dtype:
        return model
    return (shadow or ComputeShadow(compute_dtype))(model)


@torch.no_grad()
def _beam_search(model, batch: Dict[str, torch.Tensor], beam_size: int,
                 out_size: int, early_exit: bool, compute_dtype, beam_resident: bool,
                 head_kernel, attn_kernel: bool, resident_kernel: bool,
                 dropout_seed: Optional[int] = None, shadow: Optional[ComputeShadow] = None,
                 language_table: Optional[torch.Tensor] = None, return_probs: bool = False):
    """``beam_search`` that also returns the number of decode steps run; it
    decodes ``_running_model(model, compute_dtype, shadow)``.  With
    ``dropout_seed`` that model runs in train mode, the encoder on the
    stream ``fold_in(seed, max_len)`` and step t on ``fold_in(seed, t)``
    (the JAX package's folds), inside a fork of the CPU and the device's
    RNG; its mode is restored after."""
    _check_out_size(out_size, beam_size)
    model = _running_model(model, compute_dtype, shadow)
    device = next(model.parameters()).device
    was_training = model.training
    model.train(dropout_seed is not None)

    def decode(stream):
        decoder = _Stream(model, batch, beam_size, beam_resident, head_kernel, attn_kernel,
                          resident_kernel, stream, language_table, return_probs)
        steps = _run([decoder], early_exit)
        return decoder.finish(out_size) + (steps,)

    try:
        if dropout_seed is None:
            return decode(None)
        with rng.fork(device):
            return decode(lambda i: rng.reseed(rng.fold_in(dropout_seed, i), device))
    finally:
        model.train(was_training)


def _check_out_size(out_size: int, beam_size: int) -> None:
    if not 1 <= out_size <= beam_size:
        raise ValueError(f"out_size {out_size} must lie in [1, beam_size={beam_size}]")


def _run(streams, early_exit: bool) -> int:
    """Step every stream in turn at each t until max_len, or (with
    ``early_exit``) until no beam of any stream is alive at t >= 2, which
    changes no observable output; returns the steps run."""
    max_len = streams[0].max_len
    for t in range(max_len):
        if early_exit and t >= 2 and not any(s.alive() for s in streams):
            return t
        for s in streams:
            s.step(t)
    return max_len


class _Stream:
    """The decode of one batch, step by step: the encoder and the cache at
    construction, ``step(t)`` for each step, ``finish`` for the sorted
    outputs.  ``stream(i)`` (when given) seeds the dropout of the encoder
    (i = max_len) and of step i.  With ``return_probs`` every step
    selects through full distributions (fast select and the head kernel
    off, as in the JAX package) and keeps them."""

    def __init__(self, model, batch, beam_size, beam_resident, head_kernel, attn_kernel,
                 resident_kernel, stream=None, language_table=None, return_probs=False):
        if resident_kernel or head_kernel or attn_kernel:
            beam_resident = True  # the kernels implement the beam-resident math
        if beam_resident and not _supports_beam_resident(model):
            beam_resident = resident_kernel = head_kernel = attn_kernel = False
        # the full distributions: the fused selections never materialise them
        self.fast_select = beam_resident and not return_probs
        self.head_kernel = bool(head_kernel) and self.fast_select
        # a tensor-parallel model (parallel.tensor_parallel.shard_model):
        # fast selection merges each rank's vocab shard's top-k and lse
        self.mesh = getattr(model, "parallel_mesh", None)
        model_parallel = 1 if self.mesh is None else self.mesh.axis_size("model")
        self.vocab_parallel = model_parallel > 1 and self.fast_select
        self.model, self.beam_size, self.beam_resident = model, beam_size, beam_resident
        self.attn_kernel, self.resident_kernel, self.stream = attn_kernel, resident_kernel, stream
        param = next(model.parameters())
        device, dtype = param.device, param.dtype
        # every floating input runs in the compute dtype, as in the JAX package
        # (beam_search.py:317-321): the ORT's pixel boxes round to bf16 too
        batch = {
            key: value.to(device=device, dtype=dtype if value.is_floating_point() else None)
            for key, value in batch.items()
        }

        vocab = model.vocab
        self.max_len = max_len = vocab.max_caption_length
        self.eos_idx, self.vocab_size = vocab.eos_idx, len(vocab)

        # 1) encode once at batch size; beam-resident decode keeps the cross
        # K/V at image granularity, the default path expands them to beams
        if stream is not None:
            stream(max_len)  # never a step's index
        memory, memory_mask = model.encoder_forward(batch)
        self.b_s = b_s = memory.shape[0]
        if not beam_resident:
            memory = _expand_to_beams(memory, beam_size)
            memory_mask = _expand_to_beams(memory_mask, beam_size)
        self.memory_mask = memory_mask
        n_rows = b_s * beam_size
        # the layers that run a whole-layer kernel keep every head
        whole_heads = model.decoder.kernel_layers(beam_resident, resident_kernel, attn_kernel)
        cache = make_decode_cache(model.config.DECODER, vocab, n_rows, dtype=dtype,
                                  device=device, model_parallel=model_parallel,
                                  whole_heads=whole_heads)
        self.cache = model.prepare_cache(cache, memory, whole_heads)
        if language_table is not None:
            self.cache["language_table"] = language_table.to(device=device, dtype=dtype)

        f32 = dict(dtype=torch.float32, device=device)
        self.seq_logprob = torch.full((b_s, beam_size), -1e18, **f32)
        self.seq_logprob[:, 0] = 0.0
        self.seq_mask = torch.ones((b_s, beam_size), **f32)
        self.selected_words = torch.full((n_rows, 1), vocab.bos_idx, dtype=torch.long,
                                         device=device)
        self.outputs = torch.zeros((b_s, beam_size, max_len), dtype=torch.long, device=device)
        self.log_probs = torch.zeros((b_s, beam_size, max_len), **f32)
        # each step's eos-masked distributions, never re-gathered on later
        # reorders, only sorted at the end (the reference's, beam_search.py:68-72)
        self.all_log_probs = (torch.zeros((b_s, beam_size, max_len, self.vocab_size), **f32)
                              if return_probs else None)
        self.ancestry = None
        if beam_resident:
            self.ancestry = torch.zeros((b_s, beam_size, max_len), dtype=torch.long,
                                        device=device)
        self.own_slot = torch.arange(beam_size, device=device)[None, :]
        self.not_first = torch.arange(self.vocab_size, device=device) >= 1

    def alive(self) -> bool:
        return bool((self.seq_mask > 0).any())

    def step(self, t: int) -> None:
        model, b_s, beam_size = self.model, self.b_s, self.beam_size
        device = self.seq_mask.device
        if self.beam_resident:
            # position t of every current beam lives at its own slot
            self.ancestry[:, :, t] = self.own_slot
        if self.stream is not None:
            self.stream(t)
        head, self.cache = model.decode_step(
            t, self.selected_words, self.cache, self.memory_mask, ancestry=self.ancestry,
            beam_select=beam_size if self.beam_resident else None,
            # fast select goes through raw logits + logsumexp
            raw_head="hidden" if self.head_kernel or self.vocab_parallel else self.fast_select,
            resident_kernel=self.resident_kernel, attn_kernel=self.attn_kernel,
        )
        seq_logprob, seq_mask = self.seq_logprob, self.seq_mask
        prev_words = self.selected_words.reshape(b_s, beam_size)
        if t > 0:
            seq_mask = seq_mask * (prev_words != self.eos_idx).float()
            finished = seq_mask == 0.0
        else:
            finished = torch.zeros((b_s, beam_size), dtype=torch.bool, device=device)
        if self.fast_select:
            if self.head_kernel or self.vocab_parallel:
                if self.vocab_parallel:
                    vals, idxs, lse_rows = vocab_parallel_topk(
                        head, model.decoder.fc, beam_size, kernel=self.head_kernel)
                else:
                    vals, idxs, lse_rows = head_topk(
                        head.to(torch.bfloat16).contiguous(),
                        model.decoder.fc.weight.to(torch.bfloat16).contiguous(),
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
                    logits.reshape(b_s, beam_size, self.vocab_size), seq_logprob - lse,
                    finished, seq_logprob, beam_size,
                )
            selected_logprob, selected_beam, words, selected_logit = selected
            lse_sel = _gather_beams(lse, selected_beam)
            fin_sel = _gather_beams(finished, selected_beam)
            this_word_logprob = torch.where(
                fin_sel, torch.zeros_like(lse_sel), selected_logit - lse_sel
            )
        else:
            # full distributions with the reference's -999 continuation:
            # a finished beam keeps word 0 at its frozen log-prob, every
            # other word at -999, and adds a zero word log-prob
            word_logprob = head.float().reshape(b_s, beam_size, self.vocab_size)
            candidate = seq_logprob[..., None] + word_logprob
            if t > 0:
                live = seq_mask[..., None]
                word_logprob = word_logprob * live
                old = torch.where(self.not_first, -999.0, seq_logprob[..., None])
                candidate = live * candidate + old * (1.0 - live)
            selected_logprob, selected_beam, words = _select_topk(candidate, beam_size)
            this_word_logprob = torch.gather(
                _gather_beams(word_logprob, selected_beam), 2, words[..., None]
            )[..., 0]
            if self.all_log_probs is not None:
                self.all_log_probs[:, :, t] = word_logprob

        if self.beam_resident:
            # reorder the small per-beam state; the caches stay put
            self.ancestry = _gather_beams(self.ancestry, selected_beam)
        else:
            self.cache = _reorder_cache(self.cache, selected_beam)
        self.seq_mask = _gather_beams(seq_mask, selected_beam)
        self.outputs = _gather_beams(self.outputs, selected_beam)
        self.outputs[:, :, t] = words
        self.log_probs = _gather_beams(self.log_probs, selected_beam)
        self.log_probs[:, :, t] = this_word_logprob
        self.seq_logprob = selected_logprob
        self.selected_words = words.reshape(b_s * beam_size, 1)

    def finish(self, out_size: int):
        """(outputs, log_probs) sorted by the final sequence log-prob
        (stable: ties keep beam order), cut to ``out_size`` beams and
        squeezed at 1; with ``return_probs`` also the kept distributions
        (bs, beam, max_len, vocab), sorted alike, uncut."""
        sort_idxs = torch.argsort(-self.seq_logprob, dim=1, stable=True)
        outputs = _gather_beams(self.outputs, sort_idxs)[:, :out_size]
        log_probs = _gather_beams(self.log_probs, sort_idxs)[:, :out_size]
        if out_size == 1:
            outputs, log_probs = outputs[:, 0], log_probs[:, 0]
        if self.all_log_probs is None:
            return outputs, log_probs
        return outputs, log_probs, _gather_beams(self.all_log_probs, sort_idxs)


def beam_search(model, batch: Dict[str, torch.Tensor], beam_size: int,
                out_size: int = 1, early_exit: bool = True,
                compute_dtype: Optional[torch.dtype] = None,
                beam_resident: bool = True, head_kernel=False,
                attn_kernel: bool = False, resident_kernel: bool = False,
                train_dropout_rng=None, language_table: Optional[torch.Tensor] = None,
                return_probs: bool = False):
    """Run batched beam search; returns (outputs, log_probs), and with
    ``return_probs`` a third output (see below).

    outputs: (bs, out_size, max_len) int64 token ids, log_probs: the
    per-step word log-probs (f32) likewise, both squeezed to (bs, max_len)
    when ``out_size == 1``.  ``batch`` holds the model's input features;
    they move to the model's device.  ``compute_dtype`` (e.g.
    ``torch.bfloat16``) runs the network in that dtype (a converted copy,
    made for this call, if the model holds another: ``BeamSearcher`` keeps
    its copy across calls); selection stays f32.  ``train_dropout_rng`` (an
    int seed, or a ``torch.Generator`` that gives one draw) samples with
    dropout active, reproducibly from it; the global RNG state is left as
    it was.

    The flags keep the JAX package's names and precedence.
    ``beam_resident=False`` is the JAX default path (caches reordered every
    step, full distributions); the port defaults to beam-resident, the path
    its serving uses, and selects through raw logits and their logsumexp
    (the JAX ``fast_select``, on with beam-resident).  Any kernel flag
    forces beam-resident: a true ``head_kernel`` selects through the
    fused head + lse + top-k (ops/head_topk.py) at every step (here, as in
    the JAX function, it forces; ``BeamSearcher`` resolves ``True`` through
    ``_head_kernel_wins``), ``attn_kernel`` runs each
    self-attention through ops/beam_select_attention.py and
    ``resident_kernel`` each layer through ops/resident_layer_step.py
    (with both, ``attn_kernel`` wins, as in the JAX package).
    ``OPENVIIC_FUSED_STEP=1`` runs each layer of the non-resident path
    through ops/fused_decoder_step.py.  Each kernel runs its plain version
    on the CPU and the CUDA kernel on a card.  ``language_table`` serves the
    adaptive decoder (see the module's docstring).

    ``return_probs`` (the JAX flag) selects through the full per-step
    distributions, fast select and the head kernel off (the other flags
    stay), and returns them as a third output, (bs, beam_size, max_len,
    vocab) f32: at step t each slot's eos-masked word log-probs, in the
    slot order of step t (not re-gathered on later reorders, as in the
    reference), the slots sorted at the end with the beams, all of them
    whatever ``out_size``; zero past an early exit."""
    seed = None if train_dropout_rng is None else rng.seed_of(train_dropout_rng)
    *outputs, _ = _beam_search(
        model, batch, beam_size, out_size, early_exit, compute_dtype, beam_resident,
        head_kernel, attn_kernel, resident_kernel, seed, language_table=language_table,
        return_probs=return_probs,
    )
    return tuple(outputs)


@torch.no_grad()
def beam_search_multi(model, batches, beam_size: int, out_size: int = 1,
                      compute_dtype: Optional[torch.dtype] = None,
                      beam_resident: bool = True) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Decode several batches in one loop (the JAX ``beam_search_multi``):
    at each step every batch's step runs in turn, and the loop ends when
    no beam of any batch is alive (t >= 2).  A batch whose beams have
    all finished steps on as a no-op, so each batch's (outputs, log_probs)
    equal ``beam_search`` of it alone with the same flags.  The JAX
    function fuses the batches into one while loop for XLA to interleave;
    on the card this is the plain interleaved loop."""
    _check_out_size(out_size, beam_size)
    model = _running_model(model, compute_dtype, None)
    was_training = model.training
    model.eval()
    try:
        streams = [_Stream(model, batch, beam_size, beam_resident, False, False, False)
                   for batch in batches]
        _run(streams, early_exit=True)
        return [s.finish(out_size) for s in streams]
    finally:
        model.train(was_training)


# The head kernel's win region on the H100, measured by chip_smoke.py's
# head-gate phase: one beam-resident selection step, the kernel +
# _finish_select against fast select, from one image to 3200 rows at beams
# 1, 3, 5, 8 and 16, on an H100 80GB HBM3 at 700 W (PERF.md section 6).  The
# kernel won at every point measured, in three sweeps: fast select's
# per-beam argmax rounds cost more launches than the whole kernel at every
# size.  Above k = 16 the kernel keeps its lists in shared memory, which the
# sweep did not time, so fast select stays there.  The JAX package's
# thresholds (openviic_tpu/decoding/beam_search.py:762) are TPU v5e numbers.
HEAD_KERNEL_MAX_BEAM = 16


def _head_kernel_wins(b_s: int, beam_size: int) -> bool:
    """Whether the fused head + top-k kernel beats fast select at b_s
    images x beam_size beams: at beams up to ``HEAD_KERNEL_MAX_BEAM``, at
    any batch (``b_s`` is kept for the JAX signature)."""
    return beam_size <= HEAD_KERNEL_MAX_BEAM


class BeamSearcher:
    """Decode callable for one model and decode configuration (the JAX
    ``BeamSearcher`` flags, and ``resident_kernel`` besides); keeps the
    count of decode steps it has run (``steps``).

    ``head_kernel`` follows the JAX ``BeamSearcher``: ``True`` is an auto
    gate, resolved per call from the batch's images and the beam through
    ``_head_kernel_wins`` (the port's own H100 thresholds); an int that is
    not a bool forces the kernel (in the JAX package it is the kernel's
    row-block size; the port's kernel chooses its own tiling, so only its
    truth counts); ``False`` never launches it.

    With a ``compute_dtype`` other than the model's, the searcher decodes a
    ``ComputeShadow`` of the model, cast once and refreshed only after the
    model's weights change (``shadow.casts`` counts both)."""

    def __init__(self, model, compute_dtype=None, beam_resident: bool = True,
                 head_kernel=False, attn_kernel: bool = False,
                 resident_kernel: bool = False):
        self.model = model
        self.compute_dtype = compute_dtype
        self.beam_resident = bool(beam_resident)
        self.head_kernel = head_kernel
        self.attn_kernel = bool(attn_kernel)
        self.resident_kernel = bool(resident_kernel)
        self.steps = 0
        self.shadow = ComputeShadow(compute_dtype) if compute_dtype is not None else None

    def effective_head_kernel(self, batch, beam_size: int) -> bool:
        """Whether this call runs the head kernel (the JAX
        ``_effective_head_kernel``)."""
        if self.head_kernel is True:
            b_s = next(iter(batch.values())).shape[0]
            return _head_kernel_wins(b_s, beam_size)
        return bool(self.head_kernel)

    def __call__(self, batch, beam_size: int, out_size: int = 1, dropout_rng=None,
                 language_table=None):
        """Decode ``batch``; returns (outputs, log_probs) as ``beam_search``.
        ``dropout_rng`` (an int seed or a ``torch.Generator``) samples with
        dropout active (the JAX ``dropout_rng``).  ``language_table`` (the
        adaptive decoder's ``compute_language_table``) replaces its per-step
        language model."""
        seed = None if dropout_rng is None else rng.seed_of(dropout_rng)
        outputs, log_probs, steps = _beam_search(
            self.model, batch, beam_size, out_size, True, self.compute_dtype,
            self.beam_resident, self.effective_head_kernel(batch, beam_size),
            self.attn_kernel, self.resident_kernel, seed, self.shadow,
            language_table=language_table,
        )
        self.steps += steps
        return outputs, log_probs
