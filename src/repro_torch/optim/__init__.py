from .adamw import AdamWState, adamw_init, adamw_update, generator_draws

__all__ = ["AdamWState", "adamw_init", "adamw_update", "generator_draws"]
