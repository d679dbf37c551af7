from csat_tpu_torch.metrics.bleu import compute_bleu, corpus_bleu, sentence_bleu  # noqa: F401
from csat_tpu_torch.metrics.meteor import Meteor, meteor_score  # noqa: F401
from csat_tpu_torch.metrics.rouge import Rouge  # noqa: F401
from csat_tpu_torch.metrics.scores import batch_bleu, bleu_output_transform, eval_accuracies  # noqa: F401
from csat_tpu_torch.metrics.acc import MatchAccMetric, match_accuracy  # noqa: F401
