"""Caption evaluation suite: the port's copy of ``openviic_tpu/evaluation``'s
Python scorers (BLEU-1..4, METEOR 1.5, ROUGE-L, CIDEr, the PTB tokenizer).

``compute_scores`` returns ``({metric: score}, {metric: per_image_scores})``
over ``{image_id: [captions]}`` dicts, as the JAX package's does.  It runs
the Python scorers only: the JAX package's native C++ METEOR and CIDEr
(``native/libopenviic_native.so``) are bit-identical to them
(``tests/test_native.py``), and binding that library is not ported yet."""

from openviic_tpu_torch.evaluation.bleu import Bleu
from openviic_tpu_torch.evaluation.cider import Cider
from openviic_tpu_torch.evaluation.meteor import MeteorClassic
from openviic_tpu_torch.evaluation.meteor15 import Meteor15 as Meteor
from openviic_tpu_torch.evaluation.ptb_tokenizer import PTBTokenizer
from openviic_tpu_torch.evaluation.rouge import Rouge


def compute_scores(gts, gen):
    all_score = {}
    all_scores = {}
    for metric in (Bleu(), Meteor(), Rouge(), Cider()):
        score, scores = metric.compute_score(gts, gen)
        all_score[str(metric)] = score
        all_scores[str(metric)] = scores
    return all_score, all_scores


__all__ = ["Bleu", "Meteor", "MeteorClassic", "Rouge", "Cider", "PTBTokenizer", "compute_scores"]
