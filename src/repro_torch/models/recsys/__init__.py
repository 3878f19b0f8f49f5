from repro_torch.models.recsys.fm import (
    FMConfig, fm_logits, fm_loss, fm_retrieval_scores, fm_value_and_grad,
    init_fm,
)

__all__ = ["FMConfig", "init_fm", "fm_logits", "fm_loss",
           "fm_retrieval_scores", "fm_value_and_grad"]
