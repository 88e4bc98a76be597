"""On-device CIDEr reward for SCST (the port's counterpart of
``openviic_tpu/training/device_reward.py``), in plain PyTorch on the
model's device.

The SCST reward's train document-frequency corpus is a list of *token
lists*, which the CIDEr scorer reads as lists of one-word reference
sentences (the reference's quirk, kept by the JAX package).  So only
unigrams carry a document frequency: a token's df is the number of train
captions that hold it, a (vocab,) table, and every longer n-gram has idf
log(N).  ``DeviceCider`` scores against token-list ground truths (only
unigrams, with the bigram-count length penalty against one-word
references); ``DeviceCiderFull`` against caption strings, with n-grams 1-4
matched through window-equality tensors, as the trainer's reward needs.
Both equal the host scorer on these inputs (within 1e-5).

Counts come from comparisons and index operations (``scatter_add_``,
``gather``, integer sums), never from a low-precision product."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def _after_first_eos_dropped(sampled: torch.Tensor, eos_idx: int,
                             special_mask: torch.Tensor) -> torch.Tensor:
    """Which hypothesis tokens survive ``Vocab.decode_caption``: none
    strictly after the first <eos>, and no special token anywhere."""
    is_eos = (sampled == eos_idx).int()
    after_eos = (torch.cumsum(is_eos, dim=1) - is_eos) > 0
    return ~after_eos & ~special_mask[sampled]


class DeviceCider:
    """Train-split statistics computed once; scores sampled token batches
    against token-list ground truths (``openviic_tpu/training/device_reward.py:35``)."""

    def __init__(self, vocab, train_captions: Sequence[List[str]], device="cuda"):
        self.vocab = vocab
        self.device = torch.device(device)
        V = len(vocab)
        # df of a token: how many train captions hold it (by string, so
        # that tokens outside the vocab keep theirs for encode_refs)
        df_str: Dict[str, float] = {}
        for caption in train_captions:
            for token in set(caption):
                df_str[token] = df_str.get(token, 0.0) + 1.0
        self.ref_len = float(np.log(max(float(len(train_captions)), 1.0)))
        df_ids = np.zeros((V,), np.float32)
        for token, count in df_str.items():
            idx = vocab.stoi.get(token)
            if idx is not None:
                df_ids[idx] = count
        self._df_str = df_str
        idf = self.ref_len - np.log(np.maximum(1.0, df_ids))
        self.idf = torch.tensor(idf, dtype=torch.float32, device=self.device)
        special = np.isin(np.arange(V), [vocab.stoi[s] for s in vocab.specials])
        self.special_mask = torch.tensor(special, device=self.device)
        self.eos_idx = vocab.eos_idx
        self.V = V

    def token_idf(self, token: str) -> float:
        return self.ref_len - np.log(max(1.0, self._df_str.get(token, 0.0)))

    def encode_refs(self, captions: Sequence[List[str]], max_ref: int
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Per image (host, once a batch): reference token ids (-1 outside
        the vocab), their idf and a valid mask, padded to ``max_ref``."""
        n = len(captions)
        ids = np.full((n, max_ref), -1, np.int32)
        idf = np.zeros((n, max_ref), np.float32)
        valid = np.zeros((n, max_ref), bool)
        for i, caption in enumerate(captions):
            for j, token in enumerate(caption[:max_ref]):
                token_id = self.vocab.stoi.get(token)
                ids[i, j] = token_id if token_id is not None else -1
                idf[i, j] = self.token_idf(token)
                valid[i, j] = True
        return ids, idf, valid

    def score(self, sampled: torch.Tensor, ref_ids: torch.Tensor, ref_idf: torch.Tensor,
              ref_valid: torch.Tensor, sigma: float = 6.0) -> torch.Tensor:
        """CIDEr of each row of ``sampled`` (N, L) against its references
        (N, R) (ids, -1 outside the vocab; idf; valid), as the host scorer."""
        N = sampled.shape[0]
        sampled = sampled.long()
        keep = _after_first_eos_dropped(sampled, self.eos_idx, self.special_mask)
        # unigram term frequencies over the vocab, by index
        tf = torch.zeros((N, self.V), dtype=torch.float32, device=sampled.device)
        tf.scatter_add_(1, sampled, keep.float())
        norm_hyp = torch.sqrt(((tf * self.idf[None, :]) ** 2).sum(dim=1))
        # the hypothesis' bigram count: its kept tokens, joined, less one
        big_hyp = (keep.sum(dim=1) - 1).clamp_min(0).float()
        ref_ids = ref_ids.long()
        tf_at_ref = torch.where(ref_ids >= 0, torch.gather(tf, 1, ref_ids.clamp_min(0)),
                                torch.zeros_like(ref_idf))
        # each reference token's vector is {token: idf}: the clipped
        # product, over the norms (zero where a norm is)
        val = torch.minimum(tf_at_ref * ref_idf, ref_idf) * ref_idf
        denom = norm_hyp[:, None] * ref_idf
        val = torch.where(denom > 0, val / torch.where(denom > 0, denom, 1.0),
                          torch.zeros_like(val))
        val = val * torch.exp(-(big_hyp ** 2) / (2 * sigma ** 2))[:, None]
        # orders 2-4 add zero: mean over 4 orders, over the references, x 10
        n_refs = ref_valid.sum(dim=1).clamp_min(1)
        return (val * ref_valid).sum(dim=1) / 4.0 / n_refs * 10.0


class DeviceCiderFull:
    """CIDEr with n-grams 1-4 against caption-string references, the
    trainer's SCST reward (``openviic_tpu/training/device_reward.py:145``):
    the df corpus is the token-list one, so unigrams carry df and every
    longer n-gram idf log(N).  N-grams match through window-equality
    tensors (L and R are tens of tokens), with the clipped-count cosine per
    order and the Gaussian length penalty over bigram counts.

    ``encode_refs`` (host, once a batch) gives reference tokens their vocab
    ids, and each token outside the vocab a negative id of its own per
    image: such tokens match each other inside that image's references and
    never a generated token."""

    def __init__(self, vocab, train_captions: Sequence[List[str]], device="cuda"):
        base = DeviceCider(vocab, train_captions, device=device)
        self.vocab = vocab
        self.device = base.device
        self.idf = base.idf
        self.ref_len = base.ref_len
        self.token_idf = base.token_idf
        self.special_mask = base.special_mask
        self.eos_idx = base.eos_idx
        self.V = base.V

    def encode_refs(self, captions_per_image, n_ref_max: int, r_max: int):
        """captions_per_image: per image, a list of caption strings (or
        token lists).  Returns (ids, idf, token valid, reference valid) as
        numpy arrays of (B, n_ref_max, r_max) and (B, n_ref_max)."""
        B = len(captions_per_image)
        ids = np.zeros((B, n_ref_max, r_max), np.int32)
        idf = np.zeros((B, n_ref_max, r_max), np.float32)
        tok_valid = np.zeros((B, n_ref_max, r_max), bool)
        ref_valid = np.zeros((B, n_ref_max), bool)
        for b, captions in enumerate(captions_per_image):
            oov: Dict[str, int] = {}
            for r, caption in enumerate(captions[:n_ref_max]):
                ref_valid[b, r] = True
                tokens = caption.split() if isinstance(caption, str) else list(caption)
                for j, token in enumerate(tokens[:r_max]):
                    token_id = self.vocab.stoi.get(token)
                    if token_id is None:
                        token_id = oov.setdefault(token, -2 - len(oov))
                    ids[b, r, j] = token_id
                    idf[b, r, j] = self.token_idf(token)
                    tok_valid[b, r, j] = True
        return ids, idf, tok_valid, ref_valid

    def encode_refs_on_device(self, captions_per_image):
        """``encode_refs`` at the batch's own sizes (the most references an
        image has, the longest reference), as tensors on the device."""
        n_ref_max = max(len(refs) for refs in captions_per_image)
        r_max = max((len(c.split()) if isinstance(c, str) else len(c)
                     for refs in captions_per_image for c in refs), default=1)
        arrays = self.encode_refs(captions_per_image, n_ref_max, r_max)
        return tuple(torch.from_numpy(a).to(self.device) for a in arrays)

    @staticmethod
    def _windows_match(a_ids, a_valid, b_ids, b_valid, n: int):
        """(..., La) against (..., Lb) token tensors -> (..., La-n+1, Lb-n+1)
        bool of equal n-windows, invalid windows excluded; and both sides'
        window validity."""
        # a side shorter than n has no window
        wa, wb = max(a_ids.shape[-1] - n + 1, 0), max(b_ids.shape[-1] - n + 1, 0)
        eq = torch.ones(a_ids.shape[:-1] + (wa, wb), dtype=torch.bool, device=a_ids.device)
        av = torch.ones(a_ids.shape[:-1] + (wa,), dtype=torch.bool, device=a_ids.device)
        bv = torch.ones(b_ids.shape[:-1] + (wb,), dtype=torch.bool, device=b_ids.device)
        for off in range(n):
            eq = eq & (a_ids[..., off : off + wa, None] == b_ids[..., None, off : off + wb])
            av = av & a_valid[..., off : off + wa]
            bv = bv & b_valid[..., off : off + wb]
        return eq & av[..., :, None] & bv[..., None, :], av, bv

    def score(self, sampled, ref_ids, ref_idf, ref_tok_valid, ref_valid, beam_size: int,
              sigma: float = 6.0) -> torch.Tensor:
        """sampled (B * beam, L); the reference tensors per image (B, n_ref,
        R).  Returns the (B * beam,) rewards."""
        N = sampled.shape[0]
        sampled = sampled.long()
        keep = _after_first_eos_dropped(sampled, self.eos_idx, self.special_mask)
        # compact the kept tokens to the front, in order (a stable sort of
        # an integer key: bool sorts are not supported on every backend);
        # the decoded string's n-grams span dropped specials
        order = torch.argsort((~keep).to(torch.int32), dim=1, stable=True)
        hyp_ids = torch.gather(sampled, 1, order)
        hyp_valid = torch.gather(keep, 1, order)
        hyp_ids = torch.where(hyp_valid, hyp_ids, self.V + 7)  # matches nothing

        def rep(x):
            return x.repeat_interleave(beam_size, dim=0)

        ref_ids_b, ref_idf_b = rep(ref_ids.long()), rep(ref_idf)
        ref_tv_b, ref_v_b = rep(ref_tok_valid), rep(ref_valid)
        big_h = (hyp_valid.sum(dim=1) - 1).clamp_min(0).float()
        big_r = (ref_tv_b.sum(dim=-1) - 1).clamp_min(0).float()
        penalty = torch.exp(-((big_h[:, None] - big_r) ** 2) / (2 * sigma ** 2))
        total = torch.zeros((N,), dtype=torch.float32, device=sampled.device)
        zero = torch.zeros((), dtype=torch.float32, device=sampled.device)
        for n in range(1, 5):
            # each hypothesis window's count within the hypothesis
            hh, hv, _ = self._windows_match(hyp_ids, hyp_valid, hyp_ids, hyp_valid, n)
            h_cnt = hh.sum(dim=-1).float()  # (N, Lw)
            if n == 1:  # unigrams weigh by the df table, longer n-grams by log(N)
                w_h = torch.where(hyp_valid, self.idf[hyp_ids.clamp(0, self.V - 1)], zero)
            else:
                w_h = torch.full_like(h_cnt, self.ref_len)
            # sqrt(sum over windows of count * w^2) is the vector's norm
            norm_h = torch.sqrt(torch.where(hv, h_cnt * w_h[..., : h_cnt.shape[-1]] ** 2,
                                            zero).sum(dim=-1))
            # each reference window's count within its reference
            rr, rv, _ = self._windows_match(ref_ids_b, ref_tv_b, ref_ids_b, ref_tv_b, n)
            r_cnt = rr.sum(dim=-1).float()  # (N, n_ref, Rw)
            if n == 1:
                w_r = torch.where(ref_tv_b, ref_idf_b, zero)
            else:
                w_r = torch.full_like(r_cnt, self.ref_len)
            w_r = w_r[..., : r_cnt.shape[-1]]
            norm_r = torch.sqrt(torch.where(rv, r_cnt * w_r ** 2, zero).sum(dim=-1))
            # the hypothesis' count of each reference window
            hr, _, _ = self._windows_match(hyp_ids[:, None, :], hyp_valid[:, None, :],
                                           ref_ids_b, ref_tv_b, n)
            h_at_r = hr.sum(dim=-2).float()  # (N, n_ref, Rw)
            # sum over reference windows of min(h, r) w^2: the clipped cosine's numerator
            num = torch.where(rv, torch.minimum(h_at_r, r_cnt) * w_r ** 2, zero).sum(dim=-1)
            denom = norm_h[:, None] * norm_r
            val = torch.where(denom > 0, num / torch.where(denom > 0, denom, 1.0), zero)
            total = total + torch.where(ref_v_b, val * penalty, zero).sum(dim=-1)
        n_refs = ref_v_b.sum(dim=-1).clamp_min(1)
        return total / 4.0 / n_refs * 10.0
