from distkeras_torch.parallel.lm import make_lm_train_step, shift_targets

__all__ = ["make_lm_train_step", "shift_targets"]
