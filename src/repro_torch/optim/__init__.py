"""Optimizers of the port (`repro.optim`): AdamW with its global-norm
clip and cosine schedule, and Adafactor, over the port's parameter
trees."""
from .adamw import (AdamWState, adamw_init, adamw_update, cosine_schedule,
                    global_norm)
from .adafactor import AdafactorState, adafactor_init, adafactor_update

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm", "AdafactorState", "adafactor_init",
           "adafactor_update"]
