from densemonoslam_tpu_torch.eval.ate import ate_rmse, rpe, align_umeyama

__all__ = ["ate_rmse", "rpe", "align_umeyama"]
