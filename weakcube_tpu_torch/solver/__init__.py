from .build import build_lr_schedule, build_optimizer, param_label  # noqa: F401
