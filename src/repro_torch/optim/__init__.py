from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer, adafactor, adamw, build_optimizer, clip_by_global_norm,
    cosine_schedule)
