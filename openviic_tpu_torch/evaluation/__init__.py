"""Caption evaluation suite: the port's copy of ``openviic_tpu/evaluation``'s
Python scorers (BLEU-1..4, METEOR 1.5, ROUGE-L, CIDEr, the PTB tokenizer).

``compute_scores`` returns ``({metric: score}, {metric: per_image_scores})``
over ``{image_id: [captions]}`` dicts, as the JAX package's does.  Where the
native library loads (``openviic_tpu_torch.native``), its CIDEr and METEOR
1.5 take the Python scorers' places; they equal them within 1e-9.  These
run on the host, as the JAX package's do."""

import os

from openviic_tpu_torch.evaluation.bleu import Bleu
from openviic_tpu_torch.evaluation.cider import Cider
from openviic_tpu_torch.evaluation.meteor import MeteorClassic
from openviic_tpu_torch.evaluation.meteor15 import Meteor15 as Meteor
from openviic_tpu_torch.evaluation.ptb_tokenizer import PTBTokenizer
from openviic_tpu_torch.evaluation.rouge import Rouge


def _metrics():
    """The scorers of ``compute_scores`` (the JAX package's ``_metrics``,
    ``openviic_tpu/evaluation/__init__.py:22-57``): native CIDEr and METEOR
    1.5 when the library loads, unless ``OPENVIIC_NATIVE=0``.  A stale
    library that lacks the METEOR 1.5 entry point the configured data needs
    (paraphrases, synonyms or neither) keeps the Python METEOR."""
    meteor, cider = Meteor(), Cider()
    if os.environ.get("OPENVIIC_NATIVE", "1") != "0":
        from openviic_tpu_torch import native

        lib = native._load()
        if lib is not None:
            cider = native.NativeCider()
            if hasattr(lib, native.meteor15_entry_point()):
                meteor = native.NativeMeteor15()
    return (Bleu(), meteor, Rouge(), cider)


def compute_scores(gts, gen):
    all_score = {}
    all_scores = {}
    for metric in _metrics():
        score, scores = metric.compute_score(gts, gen)
        all_score[str(metric)] = score
        all_scores[str(metric)] = scores
    return all_score, all_scores


__all__ = ["Bleu", "Meteor", "MeteorClassic", "Rouge", "Cider", "PTBTokenizer", "compute_scores"]
