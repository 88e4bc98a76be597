"""Batch captioning pipeline (counterpart of
``openviic_tpu/serving.py::CaptioningPipeline.caption_features``).

It takes per-image feature dicts, pads the tail chunk to the fixed batch
size, and returns caption strings decoded by the beam-resident beam search.
Loading a trained checkpoint, raw images, the directory prefetcher and the
HTTP server are not ported yet: weights come from ``state_dict`` (for
example ``compat.from_jax.state_dict_from_jax``) or are drawn from
``seed``."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from openviic_tpu_torch.builders import build_model
from openviic_tpu_torch.data.instance import Instance, InstanceList
from openviic_tpu_torch.decoding.beam_search import BeamSearcher


class CaptioningPipeline:
    def __init__(self, config, vocab, state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 beam_size: Optional[int] = None, batch_size: int = 32,
                 use_bf16: bool = True, head_kernel: Optional[bool] = None,
                 device="cuda", seed: int = 0):
        """``config`` holds ``MODEL`` and ``TRAINING`` nodes, as the JAX
        pipeline's does.  ``head_kernel`` defaults to
        ``TRAINING.DECODE_HEAD_KERNEL``; on a CUDA device every decode step
        then launches the fused head + lse + top-k kernel."""
        self.vocab = vocab
        self.device = torch.device(device)
        self.model = build_model(config.MODEL, vocab, device=self.device, seed=seed)
        if state_dict is not None:
            self.model.load_state_dict(state_dict, strict=True)
        self.compute_dtype = torch.bfloat16 if use_bf16 else torch.float32
        self.model.to(self.compute_dtype)
        self.beam_size = beam_size or config.TRAINING.EVALUATING_BEAM_SIZE
        self.batch_size = batch_size
        if head_kernel is None:
            head_kernel = config.TRAINING.get("DECODE_HEAD_KERNEL", False)
        self.searcher = BeamSearcher(self.model, self.compute_dtype, bool(head_kernel))

    def _batch(self, chunk: List[Dict]) -> Dict[str, torch.Tensor]:
        # pad the tail chunk to the fixed batch size with copies of its last
        # item, and feature rows to multiples of 8 (zero rows are masked)
        items = [Instance(**fd) for fd in chunk]
        items += [items[-1]] * (self.batch_size - len(chunk))
        pad_sizes = {}
        for key, v0 in items[0].items():
            if isinstance(v0, np.ndarray) and v0.ndim >= 2:
                longest = max(it[key].shape[0] for it in items)
                pad_sizes[key] = ((longest + 7) // 8) * 8
        arrays = InstanceList(items, pad_sizes=pad_sizes).arrays()
        return {
            key: torch.from_numpy(value).to(
                self.device,
                dtype=self.compute_dtype
                if key.endswith("_features") and value.dtype.kind == "f" else None,
            )
            for key, value in arrays.items()
        }

    def caption_features(self, feature_dicts: List[Dict], return_ids: bool = False):
        """Caption a list of per-image feature dicts (e.g. ``{"region_features":
        (n_regions, d_feature) array}``).  With ``return_ids`` also return
        the (n_images, max_len) int64 token ids."""
        captions: List[str] = []
        ids = []
        for start in range(0, len(feature_dicts), self.batch_size):
            chunk = feature_dicts[start : start + self.batch_size]
            outputs, _ = self.searcher(self._batch(chunk), self.beam_size)
            outputs = outputs[: len(chunk)].cpu().numpy()
            ids.append(outputs)
            captions.extend(self.vocab.decode_caption(outputs))
        if return_ids:
            return captions, np.concatenate(ids) if ids else np.zeros((0, 0), np.int64)
        return captions
