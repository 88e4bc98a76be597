"""The trainer's SCST pieces (the first part of the port's counterpart of
``openviic_tpu/training/trainer.py``): ``ScstSetup`` builds what the SCST
phase needs once, and ``scst_iteration`` runs one iteration of it on one
batch, on one card.  The trainer's lifecycle (data loaders, the XE epoch,
patience and the switch into SCST, checkpoints and resume) is not ported
yet; it will call these."""

from __future__ import annotations

import itertools
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from openviic_tpu_torch import native, rng
from openviic_tpu_torch.decoding import BeamSearcher
from openviic_tpu_torch.evaluation import Cider
from openviic_tpu_torch.training.device_reward import DeviceCiderFull
from openviic_tpu_torch.training.optim import make_rl_optimizer, mask_frozen
from openviic_tpu_torch.training.steps import make_scst_grad_step

# folded into the state's seed for dropout-active sampling, so that the
# sample's stream differs from the step's (the JAX trainer's 0x5C57)
SCST_SAMPLE_SALT = 0x5C57


def make_searcher(model, training) -> BeamSearcher:
    """The trainer's decode searcher from its ``TRAINING`` config
    (``openviic_tpu/training/trainer.py:404-420``): ``DECODE_DTYPE:
    bfloat16`` decodes a bf16 shadow of the f32 model, ``DECODE_HEAD_KERNEL``
    and ``DECODE_ATTN_KERNEL`` as in ``BeamSearcher``."""
    bf16 = training.get("DECODE_DTYPE") == "bfloat16"
    return BeamSearcher(model, compute_dtype=torch.bfloat16 if bf16 else None,
                        head_kernel=training.get("DECODE_HEAD_KERNEL", False) or False,
                        attn_kernel=bool(training.get("DECODE_ATTN_KERNEL", False)))


class ScstSetup:
    """What the SCST phase builds once, the counterpart of ``_ensure_scst``
    (``openviic_tpu/training/trainer.py:561-627``) on one card, without its
    mesh and multi-host branches and without a mid-SCST resume:

    - a fresh RL Adam (``make_rl_optimizer`` at ``RL_LEARNING_RATE`` over
      ``mask_frozen``'s parameters) put into ``state`` (the XE step state:
      ``params``, ``step``, ``generator``), which it then holds;
    - the SCST step at ``TRAINING_BEAM_SIZE`` (``make_scst_grad_step``);
    - the device reward (``DeviceCiderFull`` on the model's device) when
      ``TRAINING.DEVICE_REWARD`` (default on) and no ``postprocess_pairs``
      hook (a language's tokenization of the pairs, which only the host
      reward applies);
    - the host reward: native CIDEr with the train split's document
      frequencies, or the Python ``Cider`` where no native library loads.

    ``train_captions`` are the train split's captions as token lists (the
    df corpus); ``training`` the ``TRAINING`` config node; ``searcher`` the
    decode searcher (default ``make_searcher``'s)."""

    def __init__(self, model, state: dict, train_captions: Sequence[List[str]], training,
                 searcher: Optional[BeamSearcher] = None,
                 postprocess_pairs: Optional[Callable] = None):
        self.model = model
        self.vocab = model.vocab
        self.device = next(model.parameters()).device
        self.beam_size = int(training.TRAINING_BEAM_SIZE)
        self.sample_dropout = bool(training.get("SCST_SAMPLE_DROPOUT", False))
        state["optimizer"] = make_rl_optimizer(mask_frozen(model),
                                               float(training.RL_LEARNING_RATE))
        state["scheduler"] = None
        self.state = state
        self.step = make_scst_grad_step(model, self.beam_size)
        self.searcher = searcher if searcher is not None else make_searcher(model, training)
        self.postprocess_pairs = postprocess_pairs
        self.device_reward = None
        if training.get("DEVICE_REWARD", True) and postprocess_pairs is None:
            self.device_reward = DeviceCiderFull(self.vocab, train_captions, device=self.device)
        train_gts = {f"{i}": caption for i, caption in enumerate(train_captions)}
        self.train_cider = (native.NativeCider(gts=train_gts) if native.available()
                            else Cider(train_gts))

    def host_reward(self, sampled: torch.Tensor, captions: Sequence[Sequence[str]]) -> np.ndarray:
        """The reward of each sampled row on the host: decoded, paired with
        its image's references, through ``postprocess_pairs``, scored by
        ``train_cider``.  (bs * beam,) float32."""
        caps_gen = self.vocab.decode_caption(sampled.cpu().numpy(), join_words=True)
        caps_gt = list(itertools.chain(*([list(c)] * self.beam_size for c in captions)))
        gens: Dict = {f"{i}": [c] for i, c in enumerate(caps_gen)}
        gts: Dict = {f"{i}": c for i, c in enumerate(caps_gt)}
        if self.postprocess_pairs is not None:
            gts, gens = self.postprocess_pairs(gts, gens)
        return self.train_cider.compute_score(gts, gens)[1].astype(np.float32)


def scst_iteration(setup: ScstSetup, batch: Dict[str, torch.Tensor],
                   captions: Sequence[Sequence[str]], marks: Optional[Callable] = None):
    """One SCST iteration on one batch: the single-host body of
    ``train_scst``'s loop (``openviic_tpu/training/trainer.py:675-768``).

    1. sample ``beam`` captions an image with the searcher (all beams
       kept); with ``TRAINING.SCST_SAMPLE_DROPOUT`` with dropout active, on
       a seed drawn from the state's generator without advancing it and
       folded with ``SCST_SAMPLE_SALT``;
    2. reward each against its image's references, on the device or on the
       host;
    3. one SCST step.

    ``batch``: the (bs, ...) f32 features; ``captions``: each image's
    reference caption strings.  ``marks`` (optional) is called with
    ``"sample"``, ``"reward"`` and ``"step"`` as each stage ends.  Returns
    (loss, mean reward), 0-d tensors on the device."""
    def mark(stage):
        if marks is not None:
            marks(stage)

    beam = setup.beam_size
    batch = {k: v.to(setup.device) for k, v in batch.items()}
    seed = None
    if setup.sample_dropout:
        seed = rng.fold_in(rng.peek_seed(setup.state["generator"]), SCST_SAMPLE_SALT)
    outs, _ = setup.searcher(batch, beam, out_size=beam, dropout_rng=seed)
    bs = outs.shape[0]
    sampled = outs.reshape(bs * beam, -1)
    mark("sample")
    if setup.device_reward is not None:
        refs = setup.device_reward.encode_refs_on_device(list(captions))
        reward = setup.device_reward.score(sampled, *refs, beam_size=beam)
    else:
        reward = torch.from_numpy(setup.host_reward(sampled, captions)).to(setup.device)
    reward = reward.reshape(bs, beam)
    mark("reward")
    setup.state, loss = setup.step(setup.state, batch, sampled, reward)
    mark("step")
    return loss, reward.mean()
