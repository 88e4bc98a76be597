"""Trainers (the port's counterpart of ``openviic_tpu/training/trainer.py``).

``BaseTrainer`` runs the OpenViIC recipe from a config: it builds or loads
the vocab (``<CHECKPOINT_PATH>/<NAME>/vocab.bin``), six loaders (three
over annotations, three over images, the dictionary batch divided by the
beam), the model, Adam with the Noam schedule and the XE, eval and decode
steps.  ``start()`` trains XE epochs, each followed by the val loss and the
val beam decode's scores; on ``PATIENCE`` epochs without a best score it
switches to SCST with a fresh RL Adam, reloading the best checkpoint first
when the switch epoch was not the best, and a second exhaustion ends
training.  Every epoch writes ``last_model`` (``best_model`` on a best
score) through the ``TRAINING.CHECKPOINT_BACKEND`` (``native``: one
``.ckpt`` file; ``orbax``: ``training/orbax_backend.py``'s asynchronous DCP
directories), a run resumes from it bit for bit, and SIGTERM or SIGINT end
the run after the epoch in progress with its checkpoint.
``get_predictions`` writes ``test_results.json``.  ``viTrainer`` scores
captions as they are; ``enTrainer`` PTB-tokenizes them first.

``ScstSetup`` builds what the SCST phase needs once and ``scst_iteration``
runs one iteration of it.

Across processes (a process group of more than one rank, one card or the
CPU each: ``parallel/runtime.py``, started by ``train.py`` under
``torchrun``) the trainer is data parallel as the JAX trainer is on a
multi-host mesh: JAX's refusals hold (``multiprocess_refusal``); rank 0
builds the vocab behind a barrier; the train loaders are
``GrainDataLoader``s sharded by rank that drop their ragged last batch; the
XE and SCST steps are ``parallel.mesh``'s, the XE one without label
smoothing, mixed precision or several steps a call, as JAX's sharded step;
each rank scores its own SCST samples with the host CIDEr; every rank runs
the full val and test loaders, and the best, patience, switch and stop
decisions follow rank 0's scores, broadcast; rank 0 alone writes the
checkpoints (each followed by a barrier), ``metrics.jsonl`` and
``test_results.json``, and every rank loads; a collective checkpoint
backend (``MULTIHOST_COLLECTIVE``: the orbax one) is called on every rank
instead, as the JAX trainer does.  A checkpoint holds no world size, so a
run saved at one size resumes at another.

Over one host's cards (a group that ``parallel/launch.py`` starts, which
``train.py`` does without ``torchrun``) the trainer is the JAX trainer on
its single-host mesh: ``FEATURE_BATCH_SIZE`` is the global batch, whose
order every rank draws with the same seed (the native loader allowed, no
pinned shapes needed), reading only its own rows of each batch for the
sharded XE and SCST steps (the loader's ``part``); an SCST batch that
the ranks do not divide (the ragged last one) runs whole on every rank,
as JAX runs it off the mesh.  ``GRAD_ACCUM > 1`` is refused with JAX's
message.

RSTNet's frozen language-model backbone (``optim.frozen_param_mask``)
gets no Adam moments in either phase and is saved once, apart from the
per-epoch checkpoint (``checkpoint.FROZEN_NAME``); its adaptive decoder
decodes eval and SCST samples through the language-signal table, rebuilt
for every eval decode and SCST iteration since the layers around the
backbone train (not with dropout-active sampling, which needs the
per-step language model in train mode).

One process does not train over several cards: with
``TRAINING.DATA_PARALLEL`` over more than one visible card it raises,
naming the launcher.  ``TRAINING.COMPILATION_CACHE_DIR`` (or
``OPENVIIC_COMPILE_CACHE``) is the kernels' build cache
(``utils/compile_cache.py``).  JAX-only key: ``RNG_IMPL`` is checked and
does nothing."""

from __future__ import annotations

import itertools
import json
import os
import pickle
import signal
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from openviic_tpu_torch import native, rng
from openviic_tpu_torch.builders import META_TRAINER, build_model
from openviic_tpu_torch.data.datasets import DictionaryDataset, FeatureDataset
from openviic_tpu_torch.data.grain_loader import GrainDataLoader
from openviic_tpu_torch.data.loader import DataLoader, device_prefetch
from openviic_tpu_torch.data.vocab import Vocab, load_vocab
from openviic_tpu_torch.decoding import BeamSearcher
from openviic_tpu_torch.evaluation import Cider, PTBTokenizer, compute_scores
from openviic_tpu_torch.parallel import launch, runtime
from openviic_tpu_torch.parallel import mesh as dp
from openviic_tpu_torch.training import checkpoint as ckpt
from openviic_tpu_torch.training.device_reward import DeviceCiderFull
from openviic_tpu_torch.training.optim import (
    fast_forward_schedule,
    frozen_param_mask,
    make_optimizer,
    make_rl_optimizer,
    mask_frozen,
    noam_schedule,
    optimizer_state_fits,
)
from openviic_tpu_torch.training.steps import (
    init_xe_state,
    make_eval_loss_step,
    make_scst_grad_step,
    make_xe_multi_step,
    make_xe_step,
)
from openviic_tpu_torch.utils import maybe_enable_compilation_cache, setup_logger
from openviic_tpu_torch.utils.metrics import (
    MetricsLogger,
    Profiler,
    StepTimer,
    maybe_enable_nan_checks,
)

logger = setup_logger()

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
    (``openviic_tpu/training/trainer.py:561-627``):

    - the RL Adam (``make_rl_optimizer`` at ``RL_LEARNING_RATE`` over
      ``mask_frozen``'s parameters) put into ``state`` (the XE step state:
      ``params``, ``step``, ``generator``), which it then holds: fresh, or
      holding ``optimizer_state`` (a checkpoint's RL Adam ``state_dict``,
      for a mid-SCST resume) where that fits it, else fresh with a warning;
    - the SCST step at ``TRAINING_BEAM_SIZE`` (``make_scst_grad_step``; with
      a ``mesh`` across processes ``parallel.mesh.make_sharded_scst_step``);
    - the device reward (``DeviceCiderFull`` on the model's device) when
      ``TRAINING.DEVICE_REWARD`` (default on), no ``postprocess_pairs``
      hook (a language's tokenization of the pairs, which only the host
      reward applies) and no ``mesh`` (each rank then scores its own rows
      on the host, as the JAX trainer's hosts do);
    - the host reward: native CIDEr with the train split's document
      frequencies, or the Python ``Cider`` where no native library loads;
    - ``language_table``: a callable giving the adaptive decoder's signal
      table for the weights of the moment (the trainer's
      ``_language_table``), or None; called once an iteration unless the
      sampling runs with dropout.

    ``train_captions`` are the train split's captions as token lists (the
    df corpus); ``training`` the ``TRAINING`` config node; ``searcher`` the
    decode searcher (default ``make_searcher``'s)."""

    def __init__(self, model, state: dict, train_captions: Sequence[List[str]], training,
                 searcher: Optional[BeamSearcher] = None,
                 postprocess_pairs: Optional[Callable] = None,
                 optimizer_state: Optional[dict] = None,
                 language_table: Optional[Callable] = None,
                 mesh: Optional[dp.Mesh] = None):
        self.model = model
        self.vocab = model.vocab
        self.device = next(model.parameters()).device
        self.beam_size = int(training.TRAINING_BEAM_SIZE)
        self.sample_dropout = bool(training.get("SCST_SAMPLE_DROPOUT", False))
        self.learning_rate = float(training.RL_LEARNING_RATE)
        state["optimizer"] = make_rl_optimizer(mask_frozen(model), self.learning_rate)
        state["scheduler"] = None
        self.state = state
        if optimizer_state is not None:
            self.restore_optimizer(optimizer_state)
        self.step = (make_scst_grad_step(model, self.beam_size) if mesh is None
                     else dp.make_sharded_scst_step(model, self.beam_size, mesh))
        self.searcher = searcher if searcher is not None else make_searcher(model, training)
        self.postprocess_pairs = postprocess_pairs
        self.language_table = None if self.sample_dropout else language_table
        self.device_reward = None
        if training.get("DEVICE_REWARD", True) and postprocess_pairs is None and mesh is None:
            self.device_reward = DeviceCiderFull(self.vocab, train_captions, device=self.device)
        train_gts = {f"{i}": caption for i, caption in enumerate(train_captions)}
        self.train_cider = (native.NativeCider(gts=train_gts) if native.available()
                            else Cider(train_gts))

    def restore_optimizer(self, saved: dict) -> None:
        """Load an RL Adam ``state_dict`` (a mid-SCST checkpoint's) into the
        state's optimizer where it fits it; else keep the optimizer as it is,
        with a warning."""
        optimizer = self.state["optimizer"]
        if not optimizer_state_fits(optimizer, saved):
            logger.warning("Mid-SCST checkpoint optimizer state does not match the live "
                           "SCST optimizer structure; reinitialising")
            return
        optimizer.load_state_dict(saved)
        for group in optimizer.param_groups:
            group["lr"] = self.learning_rate  # the config's, as the JAX RL Adam's

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
       folded with ``SCST_SAMPLE_SALT``; else through the setup's
       ``language_table`` of the current weights where it has one;
    2. reward each against its image's references, on the device or on the
       host;
    3. one SCST step.

    ``batch``: the (bs, ...) f32 features; ``captions``: each image's
    reference caption strings.  ``marks`` (optional) is called with
    ``"table"`` (where a table is built), ``"sample"``, ``"reward"`` and
    ``"step"`` as each stage ends.  Returns
    (loss, mean reward), 0-d tensors on the device."""
    def mark(stage):
        if marks is not None:
            marks(stage)

    beam = setup.beam_size
    batch = {k: v.to(setup.device) for k, v in batch.items()}
    seed = None
    if setup.sample_dropout:
        seed = rng.fold_in(rng.peek_seed(setup.state["generator"]), SCST_SAMPLE_SALT)
    table = None
    if setup.language_table is not None:
        table = setup.language_table()
        mark("table")
    outs, _ = setup.searcher(batch, beam, out_size=beam, dropout_rng=seed,
                             language_table=table)
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


def _wait(tensor: torch.Tensor) -> None:
    """Wait until ``tensor`` is computed (bounds the host's run-ahead)."""
    if tensor.is_cuda:
        torch.cuda.current_stream(tensor.device).synchronize()


def _check_config(config, device: torch.device) -> None:
    """Check ``RNG_IMPL``; refuse ``TRAINING.DATA_PARALLEL`` over several
    cards in one process (a process drives one card: ``parallel/launch.py``
    starts one a card)."""
    tr = config.TRAINING
    rng_impl = str(tr.get("RNG_IMPL", "threefry"))
    if rng_impl not in ("threefry", "rbg", "unsafe_rbg"):
        raise ValueError(f"TRAINING.RNG_IMPL={rng_impl!r} not recognised")
    cards = torch.cuda.device_count() if device.type == "cuda" else 1
    axis = launch.data_axis(config, cards)
    if runtime.process_count() == 1 and axis > 1:
        raise ValueError(
            f"TRAINING.DATA_PARALLEL over {axis} cards in one process: a process drives one "
            "card; run python -m openviic_tpu_torch.train, which starts one a card "
            "(parallel.launch.spawn), or set TRAINING.DATA_PARALLEL: false to train on one")


def host_local_refusal(config, world: int) -> None:
    """The JAX trainer's conditions on its single-host mesh
    (``openviic_tpu/training/trainer.py:243-257``) for a host-local group of
    ``world`` ranks."""
    if not config.TRAINING.get("DATA_PARALLEL", True):
        raise ValueError("a host-local process group trains data parallel: set "
                         "TRAINING.DATA_PARALLEL")
    launch.data_axis(config, world)  # GRAD_ACCUM's refusal


def _pad_sizes(ds) -> Dict[str, int]:
    """``DATASET.PAD_SIZES``, with ``MAX_REGIONS`` pinning every region key."""
    pad_sizes = dict(ds.get("PAD_SIZES", {}) or {})
    if ds.get("MAX_REGIONS"):
        for key in ("region_features", "region_boxes"):
            pad_sizes.setdefault(key, int(ds.MAX_REGIONS))
    return pad_sizes


def multiprocess_refusal(config) -> None:
    """The JAX trainer's refusals of a run across processes, in its words
    (``openviic_tpu/training/trainer.py:209-235``, ``:290-299``).  Its
    refusal of a global batch that the mesh does not divide cannot arise
    here: with one card a process, ``FEATURE_BATCH_SIZE`` x the world
    always divides the world's data axis."""
    tr, ds = config.TRAINING, config.DATASET
    if not tr.get("DATA_PARALLEL", True):
        raise ValueError("multi-host runs require TRAINING.DATA_PARALLEL")
    if int(tr.get("GRAD_ACCUM", 1)) > 1:
        raise ValueError("TRAINING.GRAD_ACCUM is single-device only; scale the batch across "
                         "hosts instead")
    if str(ds.get("LOADER", "native")).lower() != "grain":
        raise ValueError("multi-host training requires DATASET.LOADER: grain (the native loader "
                         "does not shard across hosts)")
    if not _pad_sizes(ds):
        raise ValueError("multi-host training requires static shapes: set DATASET.MAX_REGIONS "
                         "(or DATASET.PAD_SIZES) so every host pads identically")


def make_xe_steps(model, training, grad_accum: int, mesh: Optional[dp.Mesh]):
    """(the XE step, the k-step call or None) for ``TRAINING``: across
    processes JAX's sharded step, which ignores ``LABEL_SMOOTHING``,
    ``MIXED_PRECISION`` and ``STEPS_PER_CALL``; else ``make_xe_step`` with
    them, and ``make_xe_multi_step`` for ``STEPS_PER_CALL`` k > 1 without
    ``GRAD_ACCUM`` (as in the JAX trainer it amortises a dispatch; here the
    numerics are equal)."""
    if mesh is not None:
        return dp.make_sharded_xe_step(model, mesh), None
    smoothing = float(training.get("LABEL_SMOOTHING", 0.0))
    mixed = bool(training.get("MIXED_PRECISION", False))
    multi = None
    if int(training.get("STEPS_PER_CALL", 1)) > 1 and grad_accum <= 1:
        multi = make_xe_multi_step(model, smoothing, mixed)
    return make_xe_step(model, smoothing, mixed, grad_accum), multi


class BaseTrainer:
    """The OpenViIC training lifecycle on ``device`` (a card unless the
    caller asks for the CPU; without a card it raises)."""

    def __init__(self, config, device="cuda"):
        self.config = config
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("BaseTrainer: no CUDA device; pass device='cpu' to train on "
                               "the CPU")
        maybe_enable_compilation_cache(config)  # before the first kernel builds
        _check_config(config, self.device)
        tr, ds = config.TRAINING, config.DATASET
        self._ckpt_io = ckpt.get_backend(str(tr.get("CHECKPOINT_BACKEND", "native")))
        # across processes (parallel/runtime.py) every rank runs this
        # constructor; rank 0 alone writes files, each write behind a barrier,
        # but every rank calls into a collective checkpoint backend
        self._multiprocess = runtime.process_count() > 1
        self._writer = runtime.process_index() == 0
        host_local = runtime.host_local()
        self._ckpt_collective = self._multiprocess and bool(
            getattr(self._ckpt_io, "MULTIHOST_COLLECTIVE", False))

        self.checkpoint_path = os.path.join(tr.CHECKPOINT_PATH, config.MODEL.NAME)
        os.makedirs(self.checkpoint_path, exist_ok=True)
        vocab_file = os.path.join(self.checkpoint_path, "vocab.bin")
        if not self._writer:
            runtime.barrier("vocab")  # rank 0 builds and pickles it first
        if self._writer and not os.path.isfile(vocab_file):
            logger.info("Creating vocab")
            self.vocab = self.load_vocab(config)
            with open(vocab_file, "wb") as f:
                pickle.dump(self.vocab, f)
        else:
            logger.info("Loading vocab from %s", vocab_file)
            self.vocab = load_vocab(vocab_file)
        if self._writer and self._multiprocess:
            runtime.barrier("vocab")

        logger.info("Loading data")
        self.train_dataset, self.dev_dataset, self.test_dataset = \
            self.load_feature_datasets(ds)
        self.train_dict_dataset, self.dev_dict_dataset, self.test_dict_dataset = \
            self.load_dict_datasets(ds)
        self.configuring_hyperparameters(config)

        grad_accum = int(tr.get("GRAD_ACCUM", 1))
        if grad_accum > 1 and ds.FEATURE_BATCH_SIZE % grad_accum:
            raise ValueError(f"TRAINING.GRAD_ACCUM={grad_accum} must divide "
                             f"DATASET.FEATURE_BATCH_SIZE={ds.FEATURE_BATCH_SIZE}")
        # the data axis across processes: each rank's loader batch is its
        # share of the global batch
        self.mesh = None
        if self._multiprocess or host_local:
            if host_local:
                host_local_refusal(config, runtime.process_count())
            else:
                multiprocess_refusal(config)
            self.mesh = dp.make_mesh()
            logger.info("Data-parallel over %d %s", self.mesh.size,
                        "local devices" if host_local else "processes")
        # DATASET.LOADER: grain shards the train streams by rank; on one
        # host every rank draws the global batches of either loader and
        # reads its part of each (DataLoader's ``part``).  The eval streams
        # stay whole on every rank, so every rank takes the same decisions.
        # DATASET.MAX_REGIONS pins every region key to one row count,
        # DATASET.PAD_SIZES any key; other variable keys are bucket-padded
        loader_cls, eval_kw, train_kw = DataLoader, {}, {}
        if str(ds.get("LOADER", "native")).lower() == "grain":
            loader_cls, eval_kw = GrainDataLoader, {"shard_index": 0, "shard_count": 1}
        if host_local:
            train_kw = dict(eval_kw, part=(self.mesh.rank, self.mesh.size))
        pad_sizes = _pad_sizes(ds)
        kw = {"pad_sizes": pad_sizes} if pad_sizes else {}
        eval_kw.update(kw)
        train_kw.update(kw)
        # grad accumulation needs every batch divisible by GRAD_ACCUM, and
        # the data axis equal batches on every rank, so the ragged last
        # batch is dropped; else it is kept.  The SCST batches drop it
        # across hosts only: on one host every rank runs it whole
        self.train_dataloader = loader_cls(self.train_dataset, ds.FEATURE_BATCH_SIZE,
                                           shuffle=True, seed=13,
                                           drop_last=self.mesh is not None or grad_accum > 1,
                                           **train_kw)
        self.val_dataloader = loader_cls(self.dev_dataset, ds.FEATURE_BATCH_SIZE, **eval_kw)
        self.test_dataloader = loader_cls(self.test_dataset, ds.FEATURE_BATCH_SIZE, **eval_kw)
        self.train_dict_dataloader = loader_cls(
            self.train_dict_dataset, max(1, ds.DICT_BATCH_SIZE // self.training_beam_size),
            shuffle=True, seed=17, drop_last=self._multiprocess and not host_local,
            **train_kw)
        self.val_dict_dataloader = loader_cls(
            self.dev_dict_dataset, max(1, ds.DICT_BATCH_SIZE // self.evaluating_beam_size),
            **eval_kw)
        self.test_dict_dataloader = loader_cls(self.test_dict_dataset, 1, **eval_kw)
        # the JAX constructor draws one train batch as its init template,
        # which advances the loader's epoch counter: the port needs no
        # template but advances it the same, so both shuffle alike
        self.train_dataloader.epoch += 1

        logger.info("Building model")
        seed = int(tr.get("SEED", 42))
        self.model = build_model(config.MODEL, self.vocab, device=self.device, seed=seed)
        # {name: trainable}, or None: RSTNet's language-model backbone gets
        # no Adam moments (mask_frozen) and a checkpoint file of its own
        self._frozen_mask = frozen_param_mask(self.model)
        optimizer, scheduler = self._xe_optimizer()
        self.state = init_xe_state(self.model, optimizer, scheduler, seed=seed)
        if self.mesh is not None:  # every rank starts from rank 0's state
            dp.shard_state(self.model, self.state, self.mesh)
        self.lr_schedule = noam_schedule(config.MODEL.ENCODER.D_MODEL, self.warmup,
                                         tr.LEARNING_RATE)
        self.xe_step, self.xe_multi_step = make_xe_steps(self.model, tr, grad_accum, self.mesh)
        self.steps_per_call = int(tr.get("STEPS_PER_CALL", 1))
        self.eval_step = make_eval_loss_step(self.model)
        self.beam_searcher = make_searcher(self.model, tr)
        # the bf16 decode guard: on the first metric eval, one batch decoded
        # again at f32; token disagreement above the tolerance is flagged
        guard_cfg = tr.get("DECODE_DTYPE_GUARD", None)
        self._dtype_guard_enabled = (tr.get("DECODE_DTYPE") == "bfloat16"
                                     and (guard_cfg is None or bool(guard_cfg)))
        self._dtype_guard_tol = float(tr.get("DECODE_DTYPE_GUARD_TOL", 0.02))
        self._dtype_guard_done = False
        self._guard_searcher = None
        self.last_decode_dtype_guard = None
        self.scst_setup: Optional[ScstSetup] = None  # built on the switch to RL
        self._rl_optimizer_state = None  # a mid-SCST checkpoint's RL Adam
        self.use_rl = False
        self.epoch = 0
        self.scores_agreed = None  # across processes: the last val scores' agreement

        maybe_enable_nan_checks(bool(tr.get("DEBUG_NANS", False)))
        # one writer per run directory
        self.metrics = MetricsLogger(self.checkpoint_path,
                                     tensorboard=bool(tr.get("TENSORBOARD", False)),
                                     enabled=self._writer)
        self.log_every = int(tr.get("LOG_EVERY", 50))
        self.profiler = Profiler(self.checkpoint_path) if tr.get("PROFILE", False) else None

    # -- hooks ----------------------------------------------------------
    def configuring_hyperparameters(self, config) -> None:
        self.epoch = 0
        self.warmup = config.TRAINING.WARMUP
        self.score_metric = config.TRAINING.SCORE
        self.rl_learning_rate = config.TRAINING.RL_LEARNING_RATE
        self.get_scores = config.TRAINING.GET_SCORES
        self.training_beam_size = config.TRAINING.TRAINING_BEAM_SIZE
        self.evaluating_beam_size = config.TRAINING.EVALUATING_BEAM_SIZE
        self.patience_limit = config.TRAINING.PATIENCE

    def load_vocab(self, config) -> Vocab:
        return Vocab.from_config(config.DATASET)

    def load_feature_datasets(self, config):
        return tuple(FeatureDataset(path, self.vocab, config) for path in
                     (config.JSON_PATH.TRAIN, config.JSON_PATH.DEV, config.JSON_PATH.TEST))

    def load_dict_datasets(self, config):
        return tuple(DictionaryDataset(path, self.vocab, config) for path in
                     (config.JSON_PATH.TRAIN, config.JSON_PATH.DEV, config.JSON_PATH.TEST))

    def postprocess_pairs(self, gts: Dict, gens: Dict):
        """Hook for a language's tokenization of the gts / gens dicts."""
        return gts, gens

    def _xe_optimizer(self):
        """A fresh XE Adam and its Noam schedule over the model."""
        return make_optimizer(mask_frozen(self.model), self.config.MODEL.ENCODER.D_MODEL,
                              self.warmup, self.config.TRAINING.LEARNING_RATE)

    # -- phases ----------------------------------------------------------
    def train(self) -> float:
        """One XE epoch; returns its mean loss.  Losses stay on the device
        and are summed in float64 at the epoch's end; the host waits for the
        device every 16 steps only."""
        n = 0
        t0 = time.time()
        timer = StepTimer()
        step = int(self.state["step"])
        losses = []
        k = self.steps_per_call if self.xe_multi_step is not None else 1
        buf = []

        def run_buf():
            nonlocal n, step
            if len(buf) == k and k > 1 and len({items.batch_size for items, _ in buf}) == 1:
                self.state, ls = self.xe_multi_step(self.state, [b for _, b in buf])
                group = list(ls)
            else:  # the epoch's remainder, or a ragged batch: single steps
                group = []
                for _, batch in buf:
                    self.state, loss = self.xe_step(self.state, batch)
                    group.append(loss)
            for (items, _), loss in zip(buf, group):
                losses.append(loss)
                n += 1
                step += 1
                timer.update(items.batch_size)
                if self.profiler is not None:
                    self.profiler.step(step)
                if step % self.log_every == 0:
                    self.metrics.log(step, {"xe_loss": float(loss),
                                            "lr": self.lr_schedule(step - 1),
                                            "captions_per_sec": timer.rate,
                                            "epoch": self.epoch}, prefix="train/")
            if n % (16 * k) < k:
                _wait(group[-1])  # bound the host's run-ahead
            buf.clear()

        for items, batch in device_prefetch(self.train_dataloader, self.device):
            buf.append((items, batch))
            if len(buf) == k:
                run_buf()
        if buf:
            run_buf()
        running = torch.stack(losses).double().sum().item() if losses else 0.0
        dt = time.time() - t0
        avg = running / max(n, 1)
        logger.info("Epoch %d - XE loss %.4f (%d it, %.1fs, %.1f it/s)",
                    self.epoch, avg, n, dt, n / max(dt, 1e-9))
        return avg

    def _ensure_scst(self, reset_opt: bool = True) -> None:
        """Build the SCST phase once (``ScstSetup`` over the trainer's state
        and its searcher, so eval and SCST share one bf16 shadow): with a
        fresh RL Adam, or with ``reset_opt=False`` the RL Adam state of the
        checkpoint last loaded, where it fits."""
        if self.scst_setup is not None:
            return
        hook = (None if type(self).postprocess_pairs is BaseTrainer.postprocess_pairs
                else self.postprocess_pairs)  # a hook forces the host reward
        self.scst_setup = ScstSetup(
            self.model, self.state, self.train_dataset.captions, self.config.TRAINING,
            searcher=self.beam_searcher, postprocess_pairs=hook,
            optimizer_state=None if reset_opt else self._rl_optimizer_state,
            language_table=self._language_table if self._frozen_mask is not None else None,
            mesh=self.mesh)
        self._rl_optimizer_state = None

    def train_scst(self) -> float:
        """One SCST epoch over the train dictionary loader; returns its mean
        loss.  The host waits for the device every 8 iterations only."""
        self._ensure_scst()
        losses, rewards = [], []
        step = int(self.state["step"])
        for items, batch in device_prefetch(self.train_dict_dataloader, self.device):
            loss, reward = scst_iteration(self.scst_setup, batch, items["captions"])
            if self.mesh is not None:  # the global batch's mean reward
                reward = dp.sum_across(reward, self.mesh) / self.mesh.size
            losses.append(loss)
            rewards.append(reward)
            step += 1
            if len(losses) % 8 == 0:
                _wait(loss)
            if step % self.log_every == 0:
                self.metrics.log(step, {"scst_loss": float(loss), "reward": float(reward),
                                        "epoch": self.epoch}, prefix="train/")
        n = len(losses)
        running = torch.stack(losses).double().sum().item() if losses else 0.0
        running_reward = torch.stack(rewards).double().sum().item() if rewards else 0.0
        avg = running / max(n, 1)
        logger.info("Epoch %d - SCST loss %.4f reward %.4f", self.epoch, avg,
                    running_reward / max(n, 1))
        return avg

    # -- evaluation ------------------------------------------------------
    def evaluate_loss(self, dataloader: DataLoader) -> float:
        losses = []
        for _, batch in device_prefetch(dataloader, self.device):
            losses.append(self.eval_step(batch))
            if len(losses) % 8 == 0:
                _wait(losses[-1])
        val_loss = torch.stack(losses).double().mean().item() if losses else 0.0
        logger.info("Epoch %d - validation loss %.4f", self.epoch, val_loss)
        return val_loss

    def _language_table(self) -> Optional[torch.Tensor]:
        """The adaptive decoder's (vocab, d) language-signal table of the
        weights of the moment (the JAX trainer's ``_language_table``), None
        for the other decoders."""
        if self.config.MODEL.DECODER.ARCHITECTURE != "AdaptiveDecoder":
            return None
        return self.model.compute_language_table()

    def _decode_loader(self, dataloader: DataLoader, beam_size: int):
        """Yields (it, items, each image's best caption as a word list);
        the adaptive decoder's table is computed once for the whole pass."""
        table = self._language_table()
        for it, (items, batch) in enumerate(device_prefetch(dataloader, self.device)):
            outs, _ = self.beam_searcher(batch, beam_size, out_size=1, language_table=table)
            if self._dtype_guard_enabled and not self._dtype_guard_done:
                self._dtype_guard_done = True
                self._run_decode_dtype_guard(batch, beam_size, outs)
            caps_gen = self.vocab.decode_caption(
                outs.cpu().numpy().reshape(-1, self.vocab.max_caption_length),
                join_words=False)
            yield it, items, caps_gen

    def _run_decode_dtype_guard(self, batch, beam_size: int, outs_fast) -> None:
        """Decode ``batch`` again at f32 through a plain searcher (no bf16,
        no kernel) and record the token disagreement with the configured
        decode's ``outs_fast`` in ``last_decode_dtype_guard`` and
        metrics.jsonl; above ``DECODE_DTYPE_GUARD_TOL`` log a warning."""
        if self._guard_searcher is None:
            self._guard_searcher = BeamSearcher(self.model)
        ref_outs, _ = self._guard_searcher(batch, beam_size, out_size=1)
        L = self.vocab.max_caption_length
        fast = outs_fast.cpu().numpy().reshape(-1, L)
        ref = ref_outs.cpu().numpy().reshape(-1, L)
        token_disagreement = float(np.mean(fast != ref))
        seq_agreement = float(np.mean(np.all(fast == ref, axis=-1)))
        flagged = token_disagreement > self._dtype_guard_tol
        self.last_decode_dtype_guard = {"token_disagreement": token_disagreement,
                                        "seq_agreement": seq_agreement,
                                        "tol": self._dtype_guard_tol, "flagged": flagged}
        self.metrics.log(int(self.state["step"]),
                         {"token_disagreement": token_disagreement,
                          "seq_agreement": seq_agreement, "flagged": float(flagged)},
                         prefix="decode_dtype_guard/")
        if flagged:
            logger.warning(
                "bf16 decode guard: %.1f%% of tokens differ from f32 decode (%.1f%% of "
                "sequences identical; tolerance %.1f%%): this model's logit margins are too "
                "small for exact bf16 decoding.  Eval scores may shift; set "
                "TRAINING.DECODE_DTYPE: float32 for parity-critical runs or "
                "TRAINING.DECODE_DTYPE_GUARD: False to silence.",
                100 * token_disagreement, 100 * seq_agreement, 100 * self._dtype_guard_tol)
        else:
            logger.info("bf16 decode guard: %.2f%% token disagreement vs f32 (%.1f%% "
                        "sequences identical), within tolerance %.1f%%",
                        100 * token_disagreement, 100 * seq_agreement,
                        100 * self._dtype_guard_tol)

    def evaluate_metrics(self, dataloader: DataLoader) -> Dict[str, float]:
        gens, gts = {}, {}
        for it, items, caps_gen in self._decode_loader(dataloader, self.evaluating_beam_size):
            for i, (gts_i, gen_i) in enumerate(zip(items["captions"], caps_gen)):
                gens[f"{it}_{i}"] = [" ".join(k for k, _ in itertools.groupby(gen_i))]
                gts[f"{it}_{i}"] = gts_i
        gts, gens = self.postprocess_pairs(gts, gens)
        scores, _ = compute_scores(gts, gens)
        # BLEU's four values as BLEU-1..4, and BLEU-4 as BLEU
        flat = dict(scores)
        if isinstance(flat.get("BLEU"), (list, tuple)):
            bleu = flat.pop("BLEU")
            for i, b in enumerate(bleu, start=1):
                flat[f"BLEU-{i}"] = b
            flat["BLEU"] = bleu[-1]
        return flat

    # -- checkpointing ---------------------------------------------------
    def save_checkpoint(self, extras: Dict) -> None:
        # the shuffle counters travel with the checkpoint: the XE loader
        # advances only in XE epochs and the dict loader only in SCST ones
        loader_epochs = {"train": int(self.train_dataloader.epoch),
                         "train_dict": int(self.train_dict_dataloader.epoch)}
        # the state is the same on every rank: rank 0 writes it, unless the
        # backend is collective (every rank then calls it, and it fences
        # its own writes)
        if self._writer or self._ckpt_collective:
            self._ckpt_io.save_checkpoint(
                os.path.join(self.checkpoint_path, self._ckpt_io.LAST_NAME), self.model,
                self.state, {"epoch": self.epoch, "loader_epochs": loader_epochs, **extras},
                frozen_mask=self._frozen_mask)
        if self._multiprocess and not self._ckpt_collective:
            runtime.barrier("ckpt_save")  # no rank loads before the file is whole

    def load_checkpoint(self, fname: str) -> Optional[Dict]:
        """Restore the checkpoint ``fname`` (None when absent): the weights
        copied into the live parameters (so the decode's bf16 shadow sees
        them change), the step and the state generator; an XE checkpoint's
        optimizer and schedule (fresh moments with the schedule
        fast-forwarded to the step when it has none or they do not fit);
        an SCST checkpoint's RL Adam is kept for ``_ensure_scst``."""
        loaded = self._ckpt_io.load_checkpoint(fname)
        if loaded is None:
            return None
        live = self.model.state_dict()
        if {k: tuple(v.shape) for k, v in loaded["model"].items()} != {
                k: tuple(v.shape) for k, v in live.items()}:
            raise ValueError(f"{fname} holds another model's weights")  # nothing restored
        logger.info("Loaded checkpoint from %s (epoch %s)", fname, loaded.get("epoch"))
        self.model.load_state_dict(loaded["model"])
        self.state["step"] = int(loaded["step"])
        self.state["generator"].set_state(loaded["generator"])
        saved = loaded["optimizer"]
        if saved is not None and loaded.get("use_rl"):
            if self.scst_setup is not None:  # already in SCST
                self.scst_setup.restore_optimizer(saved)
            else:
                self._rl_optimizer_state = saved
            return loaded
        optimizer, scheduler = self._xe_optimizer()
        if saved is None:
            logger.info("Checkpoint has no optimizer state; starting it fresh (LR schedule "
                        "fast-forwarded to step %s)", loaded["step"])
            fast_forward_schedule(optimizer, scheduler, loaded["step"])
        elif optimizer_state_fits(optimizer, saved) and loaded["scheduler"] is not None:
            optimizer.load_state_dict(saved)
            scheduler.load_state_dict(loaded["scheduler"])
        else:
            logger.warning("Checkpoint optimizer state does not match the XE optimizer "
                           "structure; reinitialising the optimizer")
            fast_forward_schedule(optimizer, scheduler, loaded["step"])
        self.state["optimizer"], self.state["scheduler"] = optimizer, scheduler
        return loaded

    def _agreed(self, val_loss: float, scores: Dict[str, float]):
        """Rank 0's val loss and scores on every rank (each rank ran the
        whole val loaders); whether every rank's own agreed is logged and
        kept in ``scores_agreed``."""
        gathered = runtime.all_gather_object((val_loss, scores))
        self.scores_agreed = all(g == gathered[0] for g in gathered)
        logger.info("Epoch %d - the ranks' own val scores agree with rank 0's: %s", self.epoch,
                    self.scores_agreed)
        return gathered[0]

    # -- main loop -------------------------------------------------------
    def start(self, max_epochs: Optional[int] = None) -> None:
        """Train from ``last_model`` if there is one, else from scratch.  On
        SIGTERM or SIGINT the epoch in progress finishes, its checkpoint is
        written and the loop ends; a second signal restores the handlers
        and raises ``KeyboardInterrupt``.  Handlers are set on the main
        thread only."""
        last = os.path.join(self.checkpoint_path, self._ckpt_io.LAST_NAME)
        best_file = os.path.join(self.checkpoint_path, self._ckpt_io.BEST_NAME)
        self._stop_requested = False
        prev_handlers = {}

        def request_stop(signum, frame):
            if self._stop_requested:
                for s, h in prev_handlers.items():
                    signal.signal(s, h)
                raise KeyboardInterrupt
            self._stop_requested = True
            logger.info("Signal %s: will checkpoint and exit after this epoch", signum)

        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                prev_handlers[sig] = signal.signal(sig, request_stop)
        except ValueError:
            prev_handlers = {}  # not the main thread
        try:
            self._start_loop(max_epochs, last, best_file)
        finally:
            for sig, h in prev_handlers.items():
                signal.signal(sig, h)

    def _restore_loader_epochs(self, loaded: Dict, use_rl: bool) -> None:
        """The loaders' shuffle counters on resume: the checkpoint's, else
        (a checkpoint without them) the XE phase's reconstruction: after XE
        epoch e the train counter is e + 2 = ``self.epoch + 1`` (the
        constructor's draw, then one a epoch) and the dict loader's 0."""
        le = loaded.get("loader_epochs") or {}
        self.train_dataloader.epoch = int(le.get("train", self.epoch + 1))
        self.train_dict_dataloader.epoch = int(
            le.get("train_dict", self.epoch + 1 if use_rl else 0))

    def _start_loop(self, max_epochs, last, best_file) -> None:
        loaded = self.load_checkpoint(last)
        if loaded is not None:
            use_rl = loaded["use_rl"]
            best_val_score = loaded["best_val_score"]
            patience = loaded["patience"]
            # the checkpoint marks its epoch completed: resume at the next
            self.epoch = loaded["epoch"] + 1
            self._restore_loader_epochs(loaded, use_rl)
            if use_rl:
                self._ensure_scst(reset_opt=False)
        else:
            use_rl, best_val_score, patience = False, 0.0, 0
        self.use_rl = use_rl

        epochs_run = 0
        while True:
            if not self.use_rl:
                self.train()
            else:
                self.train_scst()
            val_loss = self.evaluate_loss(self.val_dataloader)
            scores = self.evaluate_metrics(self.val_dict_dataloader)
            if self._multiprocess:
                val_loss, scores = self._agreed(val_loss, scores)
            logger.info("Validation scores %s", scores)
            val_score = scores[self.score_metric]

            best = False
            if val_score >= best_val_score:
                best_val_score, patience, best = val_score, 0, True
            else:
                patience += 1

            switch_to_rl = exit_train = False
            if patience == self.patience_limit:
                if not self.use_rl:
                    self.use_rl = switch_to_rl = True
                    patience = 0
                    self._ensure_scst()
                    logger.info("Switching to RL")
                else:
                    logger.info("patience reached.")
                    exit_train = True

            if switch_to_rl and not best and self._ckpt_io.exists(best_file):
                self.load_checkpoint(best_file)
                self.scst_setup = None  # a fresh RL Adam over the reloaded weights
                self._ensure_scst()

            self.save_checkpoint({"val_loss": val_loss, "best_val_score": best_val_score,
                                  "patience": patience, "use_rl": self.use_rl})
            if best:
                if self._writer or self._ckpt_collective:
                    self._ckpt_io.copy(last, best_file)
                if self._multiprocess and not self._ckpt_collective:
                    runtime.barrier("ckpt_best")  # the switch may load it on every rank
            # a signal may reach some ranks only: all stop, or the others
            # would wait at the next collective
            stop = self._stop_requested
            if self._multiprocess:
                stop = runtime.any_across(stop)
            if stop:
                self._ckpt_io.wait()
                logger.info("Preemption checkpoint written; exiting training loop")
                break
            if exit_train:
                break
            self.epoch += 1
            epochs_run += 1
            if max_epochs is not None and epochs_run >= max_epochs:
                logger.info("Reached max_epochs=%s", max_epochs)
                break
        self._ckpt_io.wait()

    # -- test-set predictions -------------------------------------------
    def get_predictions(self, get_scores: bool = True) -> None:
        """Decode the test split from ``best_model`` and write
        ``test_results.json``: each batch's ids, file names, captions and
        references under ``results``, and the scores."""
        best_file = os.path.join(self.checkpoint_path, self._ckpt_io.BEST_NAME)
        if not self._ckpt_io.exists(best_file):
            raise FileNotFoundError("Prediction requires a trained model: no best_model "
                                    f"checkpoint at {best_file}")
        self.load_checkpoint(best_file)

        results = []
        overall_gens, overall_gts = {}, {}
        for it, items, caps_gen in self._decode_loader(self.test_dict_dataloader,
                                                       self.evaluating_beam_size):
            gts_batch, gens_batch = {}, {}
            for i, (gts_i, gen_i) in enumerate(zip(items["captions"], caps_gen)):
                gen_i = " ".join(k for k, _ in itertools.groupby(gen_i))
                gens_batch[f"{it}_{i}"] = gen_i
                gts_batch[f"{it}_{i}"] = gts_i
                overall_gens[f"{it}_{i}"] = [gen_i]
                overall_gts[f"{it}_{i}"] = gts_i
            results.append({"image_id": [int(x) for x in np.atleast_1d(items["image_id"])],
                            "filename": [str(x) for x in np.atleast_1d(items["filename"])],
                            "gens": gens_batch, "gts": gts_batch})
        scores = {}
        if get_scores:
            overall_gts, overall_gens = self.postprocess_pairs(overall_gts, overall_gens)
            scores, _ = compute_scores(overall_gts, overall_gens)
            logger.info("Evaluation scores on test set: %s", scores)
        if self._writer:
            with open(os.path.join(self.checkpoint_path, "test_results.json"), "w+") as f:
                json.dump({"results": results, **scores}, f, ensure_ascii=False)


@META_TRAINER.register()
class viTrainer(BaseTrainer):
    """Vietnamese trainer: captions scored as they are."""


@META_TRAINER.register()
class enTrainer(BaseTrainer):
    """English trainer: references and captions PTB-tokenized before
    scoring, the SCST reward included (on the host)."""

    def __init__(self, config, device="cuda"):
        super().__init__(config, device=device)
        self._ptb = PTBTokenizer()

    def get_predictions(self, dataset=None, get_scores: bool = True):
        """As ``BaseTrainer.get_predictions``, on ``dataset`` (an image
        dataset, one image a batch) when given."""
        if dataset is not None:
            self.test_dict_dataloader = DataLoader(dataset, 1, shuffle=False)
        return super().get_predictions(get_scores=get_scores)

    def postprocess_pairs(self, gts: Dict, gens: Dict):
        ptb = getattr(self, "_ptb", None) or PTBTokenizer()
        gts_tok = ptb.tokenize({k: list(v) for k, v in gts.items()})
        gens_tok = ptb.tokenize({k: (v if isinstance(v, list) else [v])
                                 for k, v in gens.items()})
        return gts_tok, gens_tok
