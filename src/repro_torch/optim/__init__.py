from .optimizers import (AdamState, Optimizer, SGDState, adam, adamw,
                         apply_updates, clip_by_global_norm, make_optimizer,
                         sgd)

__all__ = ["AdamState", "Optimizer", "SGDState", "adam", "adamw",
           "apply_updates", "clip_by_global_norm", "make_optimizer", "sgd"]
