from splade_tpu_torch.mining.teacher_scores import precompute_teacher_scores
from splade_tpu_torch.mining.multi_negatives import mine_multi_negatives

__all__ = ["precompute_teacher_scores", "mine_multi_negatives"]
