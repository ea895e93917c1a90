from .build import build_lr_schedule, build_optimizer, freeze_bn, param_label  # noqa: F401
